"""Drivers of the paper's tables and figures on the port.

Each module rebuilds one of the reference's drivers (its cells, labels,
seeds, run counts and emitted fields) on :mod:`repro_torch`:

- :mod:`.sim_tables`: Tables 1-2, job execution times and gains against
  Young (``build_cells``, ``run_sweep``, ``run``, ``compare``);
- :mod:`.waste_curves`: Figures 4-7, waste against platform size;
- :mod:`.recall_precision`: Figures 8-11, recall against precision;
- :mod:`.simulate_cluster`: the Figure-4 trend as a terminal table.

The default engine is ``"torch"`` on CUDA with host-drawn traces (the
reference drivers' ``EngineConfig`` default trace mode, so the traces are
the reference's NumPy draws); ``--engine batch|scalar|legacy`` runs the
host engines and ``--device cpu`` the lane machine's plain PyTorch path::

    python -m repro_torch.paper.sim_tables --quick --device cpu
    python -m repro_torch.paper.waste_curves --engine batch
"""
