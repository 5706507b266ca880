"""PyTorch/CUDA port of the fault-prediction checkpointing simulator.

A package beside the JAX reference (``repro``), imported without it: the
paper grid's fused Monte-Carlo sweep
(:func:`repro_torch.experiments.run_grid`) runs on an NVIDIA Hopper card
through hand-written CUDA kernels (:mod:`repro_torch.kernels.sim_step`),
with plain PyTorch versions of every kernel for the CPU.
"""
