"""On a CUDA card: the port's selective-scan kernel (``csrc/mamba_scan.cu``)
against its plain version, at both built state sizes (8 and 16), one token
(a decode step, also in place) and sequences that end on and beside a
staging chunk's edge (16 tokens), more (batch, channel) blocks than fit the
card at once, a channel count that is not a multiple of the block's 128, a
zero initial state, strided B / C rows (the model's slices of one product),
and the wrappers' checks on the card (a backward through the wrapper
runs the backward kernel, ``test_torch_mamba_bwd_card.py``).  Imports
neither JAX nor the reference, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mamba_card.py

Without a card every test skips.

The final state must equal the plain version's bit for bit (both round
``dt A``, ``da h``, ``(dt x) B`` and their sum, and take libdevice's
``expf``; the kernel is built with ``--fmad=false``).  y sums over the
state in another order; it is held within ``Y_TOL`` of max|y| (the torch
emulation of the kernel's order in ``test_torch_mamba.py`` measures up to
2e-7 of max|y| on these input laws)."""

import pytest
import torch

from repro_torch.kernels import mamba as M
from repro_torch.kernels import ops

Y_TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _check(got, want):
    (y, h), (yw, hw) = got, want
    torch.cuda.synchronize()
    assert y.dtype == torch.float32 and y.shape == yw.shape and h.shape == hw.shape
    assert bool(torch.isfinite(y).all())
    assert torch.equal(h.view(torch.int32), hw.view(torch.int32)), \
        f"state: {int((h != hw).sum())} entries differ, max {float((h - hw).abs().max())}"
    err = float((y - yw).abs().max())
    assert err <= Y_TOL * float(yw.abs().max()), f"y off by {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("ds", M.D_STATES)
@pytest.mark.parametrize("B,S,din,with_h0", [(2, 1, 256, True), (2, 16, 128, True),
                                             (3, 17, 200, False), (1, 333, 64, True),
                                             (8, 40, 4096, True)])
def test_kernel_matches_plain_on_card(cuda_device, ds, B, S, din, with_h0):
    x = M.sample_scan_inputs(B, S, din, ds, seed=ds + S + din, device=cuda_device,
                             with_h0=with_h0)
    n0 = M.selective_scan.launches
    got = ops.selective_scan(*x)
    assert M.selective_scan.launches == n0 + 1
    _check(got, M.selective_scan_ref(*x))


@pytest.mark.cuda
@pytest.mark.parametrize("ds", M.D_STATES)
def test_decode_step_in_place(cuda_device, ds):
    dt, x, A, Bc, Cc, h0 = M.sample_scan_inputs(4, 1, 1024, ds, seed=7, device=cuda_device)
    want = M.selective_scan_ref(dt, x, A, Bc, Cc, h0)
    cache = h0.clone()
    y, h = ops.selective_scan(dt, x, A, Bc, Cc, cache, state_out=cache)
    assert h.data_ptr() == cache.data_ptr()
    _check((y, cache), want)


@pytest.mark.cuda
def test_strided_rows_and_many_blocks(cuda_device):
    """B and C sliced from one (B, S, 3 + 2 ds) product, and 16 x 16384
    channels (2,048 blocks of 128: more than one wave)."""
    ds = 16
    dt, x, A, Bc, Cc, h0 = M.sample_scan_inputs(16, 3, 16384, ds, seed=9, device=cuda_device)
    dbc = torch.cat([torch.zeros(16, 3, 3, device=cuda_device), Bc, Cc], dim=-1)
    got = ops.selective_scan(dt, x, A, dbc[..., 3:3 + ds], dbc[..., 3 + ds:], h0)
    _check(got, M.selective_scan_ref(dt, x, A, Bc, Cc, h0))


@pytest.mark.cuda
def test_card_refuses_what_the_kernel_does_not_take(cuda_device):
    dt, x, A, Bc, Cc, h0 = M.sample_scan_inputs(2, 4, 64, 4, seed=3, device=cuda_device)
    with pytest.raises(ValueError, match="d_state 4"):
        ops.selective_scan(dt, x, A, Bc, Cc, h0)
    dt, x, A, Bc, Cc, h0 = M.sample_scan_inputs(2, 4, 64, 8, seed=3, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ops.selective_scan(dt, x, A.t().contiguous().t(), Bc, Cc, h0)
    # a backward runs now, through the backward kernel (one launch)
    x.requires_grad_(True)
    y, _ = ops.selective_scan(dt, x, A, Bc, Cc, h0)
    n0 = M.selective_scan_bwd.launches
    y.sum().backward()
    assert M.selective_scan_bwd.launches == n0 + 1
    want = M.selective_scan_bwd_ref(dt, x.detach(), A, Bc, Cc, h0, torch.ones_like(y))[1]
    err = float((x.grad - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), f"dx off by {err}"
