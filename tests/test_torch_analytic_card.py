"""On a CUDA card: the batched Newton solve, whose iterations after the
first replay one captured CUDA graph of an iteration, against the same
solve on the CPU.  Imports neither JAX nor the reference, so it runs on
the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_analytic_card.py

Without a card every test skips.  Tolerance: none, the card's seven
outputs are the CPU's bits (every model op is its own elementwise ATen
kernel, the same on both sides)."""

import numpy as np
import pytest
import torch

from repro_torch.core import analytic as A
from repro_torch.experiments import paper_grid_cells
from repro_torch.kernels import analytic as K

OUTPUTS = ("T_R", "q", "waste", "T0", "waste0", "T1", "waste1")


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["validation", "full"])
def test_newton_graph_replay_matches_cpu(preset):
    """The solve issues no host sync on the card and ends on the CPU's
    bits, padding rows excluded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph replay has no CPU mode")
    tabs = A.tables_from_cells(paper_grid_cells(preset))
    args, n = A.newton_inputs(tabs, device="cuda")
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = K.newton_policy(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    host = A.newton_optimize_tables(tabs, device="cpu")
    for got, k in zip(out, OUTPUTS):
        np.testing.assert_array_equal(got[:n].cpu().numpy(), host[k], err_msg=k)


@pytest.mark.cuda
def test_graph_replay_matches_eager_loop():
    """The replayed iterations give the eager loop's bits on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph replay has no CPU mode")
    args, _ = A.newton_inputs(A.tables_from_cells(paper_grid_cells("validation")),
                              device="cuda")
    cols, lo, hi = tuple(args[:17]), args[17], args[19]
    ends = []
    for graph in (False, True):
        T = torch.clamp(torch.sqrt(2.0 * cols[5] * cols[2]), lo, hi)
        lo_b, hi_b = lo.clone(), hi.clone()
        if graph:
            K._replay_steps(cols, T, lo_b, hi_b)
        else:
            for _ in range(K.NEWTON_ITERS):
                K._newton_step(cols, T, lo_b, hi_b)
        ends.append((T, lo_b, hi_b))
    for a, b in zip(*ends):
        assert torch.equal(a.view(torch.int64), b.view(torch.int64))
