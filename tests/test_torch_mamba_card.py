"""On a CUDA card: the port's selective-scan kernel (``csrc/mamba_scan.cu``)
against its plain version, at both built state sizes (8 and 16), one token
(a decode step, also in place) and sequences that end on and beside a
staging chunk's edge (16 tokens), more (batch, channel) blocks than fit the
card at once, a channel count that is not a multiple of the block's 128, a
zero initial state, strided B / C rows (the model's slices of one product),
and the wrappers' checks on the card (a backward through the wrapper
runs the backward kernel, ``test_torch_mamba_bwd_card.py``).  The decode
kernel (S = 1) and the prefill kernel (S > 1) are also held at Jamba's
decode shape in place, at channel counts that are no multiple of either
kernel's block (1000, 4100) at one token and at two staging chunks and
five tokens, with the state and the initial state as views 4 bytes into a
larger buffer (the kernels' 4-byte path: the same bits), two calls
against each other, and y bit for bit against the torch emulation of the
kernels' order (``selective_scan_kernel_order``) run on the card.  Imports
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


def _bits(t):
    return t.contiguous().view(torch.int32)


def _chunk() -> int:
    from repro_torch.kernels import build

    return int(build.load("mamba_scan").selective_scan_fwd_chunk())


@pytest.mark.cuda
def test_decode_in_place_at_jamba_shape(cuda_device):
    """One decode step of Jamba-1.5-Large's scan (8 x 16384 x ds 16), the
    serving cache written in place, y also bit-equal to the emulation."""
    dt, x, A, Bc, Cc, h0 = M.sample_scan_inputs(8, 1, 16384, 16, seed=21, device=cuda_device)
    want = M.selective_scan_ref(dt, x, A, Bc, Cc, h0)
    emu = M.selective_scan_kernel_order(dt, x, A, Bc, Cc, h0)
    cache = h0.clone()
    n0 = M.selective_scan.launches
    y, h = ops.selective_scan(dt, x, A, Bc, Cc, cache, state_out=cache)
    assert M.selective_scan.launches == n0 + 1 and h.data_ptr() == cache.data_ptr()
    _check((y, cache), want)
    assert torch.equal(_bits(y), _bits(emu[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("ds", M.D_STATES)
@pytest.mark.parametrize("din", [1000, 4100])
@pytest.mark.parametrize("kernel", ["decode", "prefill"])
def test_ragged_channel_counts(cuda_device, kernel, din, ds):
    """Channel counts that fill neither kernel's blocks: S = 1 and S = 2c +
    5 with c the prefill's staging chunk."""
    S = 1 if kernel == "decode" else 2 * _chunk() + 5
    x = M.sample_scan_inputs(2, S, din, ds, seed=din + S + ds, device=cuda_device)
    got = ops.selective_scan(*x)
    _check(got, M.selective_scan_ref(*x))
    assert torch.equal(_bits(got[0]), _bits(M.selective_scan_kernel_order(*x)[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("ds", M.D_STATES)
@pytest.mark.parametrize("S", [1, 37])
@pytest.mark.parametrize("in_place", [False, True])
def test_state_views_four_bytes_off(cuda_device, S, ds, in_place):
    """h0 and state_out as views 4 bytes into larger buffers (not 16-byte
    aligned), A too: the kernels take 4-byte accesses and give the aligned
    call's bits; the wrapper copies nothing (state_out is written where it
    lies, in place when it is h0)."""
    B, din = 3, 640
    dt, x, A, Bc, Cc, h0 = M.sample_scan_inputs(B, S, din, ds, seed=40 + S, device=cuda_device)
    aligned = ops.selective_scan(dt, x, A, Bc, Cc, h0)
    n = B * din * ds
    hbuf = torch.zeros(n + 1, device=cuda_device)
    abuf = torch.zeros(din * ds + 1, device=cuda_device)
    h_view = hbuf[1:].view(B, din, ds)
    a_view = abuf[1:].view(din, ds)
    h_view.copy_(h0)
    a_view.copy_(A)
    assert h_view.data_ptr() % 16 == 4 and a_view.data_ptr() % 16 == 4
    if in_place:
        out_view = h_view
    else:
        obuf = torch.full((n + 1,), float("nan"), device=cuda_device)
        out_view = obuf[1:].view(B, din, ds)
    y, h = ops.selective_scan(dt, x, a_view, Bc, Cc, h_view, state_out=out_view)
    torch.cuda.synchronize()
    assert h.data_ptr() == out_view.data_ptr()
    assert torch.equal(_bits(out_view), _bits(aligned[1]))
    assert torch.equal(_bits(y), _bits(aligned[0]))
    if not in_place:
        assert torch.equal(_bits(h_view), _bits(h0))  # the initial state is left as it was
    assert float(hbuf[0]) == 0.0  # nothing written before the view
    _check((y, out_view), M.selective_scan_ref(dt, x, A, Bc, Cc, h0))


@pytest.mark.cuda
@pytest.mark.parametrize("ds", M.D_STATES)
@pytest.mark.parametrize("S", [1, 1024])
def test_two_calls_bit_equal(cuda_device, S, ds):
    x = M.sample_scan_inputs(8, S, 2048, ds, seed=50 + S, device=cuda_device)
    a, b = ops.selective_scan(*x), ops.selective_scan(*x)
    torch.cuda.synchronize()
    assert torch.equal(_bits(a[0]), _bits(b[0])) and torch.equal(_bits(a[1]), _bits(b[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("ds", M.D_STATES)
@pytest.mark.parametrize("B,S,din,with_h0", [(8, 1, 16384, True), (2, 16, 128, True),
                                             (3, 17, 200, False), (2, 333, 1000, True),
                                             (8, 64, 16384, False)])
def test_y_bit_equal_to_the_emulation_on_card(cuda_device, ds, B, S, din, with_h0):
    """The torch emulation of the kernels' order, run on the card (its exp
    is libdevice's expf), gives the kernels' y and state bit for bit; B and
    C are strided slices of one product at a 3-float offset."""
    dt, x, A, Bc, Cc, h0 = M.sample_scan_inputs(B, S, din, ds, seed=60 + S + din,
                                                device=cuda_device, with_h0=with_h0)
    dbc = torch.cat([torch.zeros(B, S, 3, device=cuda_device), Bc, Cc], dim=-1)
    got = ops.selective_scan(dt, x, A, dbc[..., 3:3 + ds], dbc[..., 3 + ds:], h0)
    want = M.selective_scan_kernel_order(dt, x, A, Bc, Cc, h0)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got[1]), _bits(want[1]))
    assert torch.equal(_bits(got[0]), _bits(want[0])), \
        f"y: {int((got[0] != want[0]).sum())} entries differ"
