"""On a CUDA card: the backward of the WKV recurrence
(``csrc/rwkv6_bwd.cu``, :func:`repro_torch.kernels.rwkv6.wkv6_bwd`)
against its plain version :func:`wkv_bwd_ref`, at every built head dim,
one token, sequences ending on and beside the edges of the kernel's
tiling (a span between stored states, ``wkv6_bwd_chunk(hd)`` tokens, and
its half, whose states a thread keeps in registers), with and without an
initial state and a final state's gradient, one batch row, a
per-batch-row ``u``, RWKV6-7B's training shape, and the path through
``ops.wkv6`` under autograd.  Imports neither JAX nor the reference, so it
runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_rwkv6_bwd_card.py

Without a card every test skips.

ds0 must equal the plain version's bit for bit (G's elementwise chain,
rounded alike, built with ``--fmad=false``); the reduced gradients (dr,
dk, dw over a row, dv over the rows, du over the batch and the sequence)
sum in other orders and are held within ``TOL`` of each gradient's max
(the CPU tests measure the plain version's own reorderings at 3e-7).  Two
calls give the same bits: no atomics."""

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6 as R

TOL = 1e-5
NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _case(B, S, H, hd, seed, dev, with_s0=True, with_dsT=True, u_batched=False):
    r, k, v, w, u, s0 = R.sample_wkv_inputs(B, S, H, hd, seed, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    dy = torch.randn((B, S, H, hd), generator=g, device=dev)
    dsT = torch.randn((B, H, hd, hd), generator=g, device=dev) * 0.1 if with_dsT else None
    u3 = (torch.randn((B, H, hd), generator=g, device=dev) * 0.1 if u_batched else u[None])
    return r, k, v, w, u3, (s0 if with_s0 else None), dy, dsT


def _check(got, want):
    torch.cuda.synchronize()
    for name, a, b in zip(NAMES, got, want):
        if b is None:
            assert a is None, name
            continue
        assert a.shape == b.shape and a.dtype == torch.float32, name
        assert bool(torch.isfinite(a).all()), name
        if name == "ds0":
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                f"ds0: {int((a != b).sum())} entries differ"
            continue
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        assert err <= TOL * scale, f"{name}: off by {err} (max {scale})"


def _chunk(hd):
    """Tokens between the states the kernel stores, from the library."""
    from repro_torch.kernels import build

    return build.load("rwkv6_bwd").wkv6_bwd_chunk(hd)


#: sequence lengths as functions of the chunk c: one token, the half-chunk
#: a thread keeps in registers and one past it, one short of a chunk, a
#: chunk, one past, two chunks and a remainder
_LENGTHS = {"1": lambda c: 1, "half": lambda c: c // 2, "half+1": lambda c: c // 2 + 1,
            "c-1": lambda c: c - 1, "c": lambda c: c, "c+1": lambda c: c + 1,
            "2c+5": lambda c: 2 * c + 5}


@pytest.mark.cuda
@pytest.mark.parametrize("hd", R.HEAD_DIMS)
@pytest.mark.parametrize("B,S,H,with_s0,with_dsT", [
    (2, "1", 3, True, True), (2, "c", 2, True, False), (1, "c+1", 3, False, True),
    (3, "2c+5", 2, True, True), (2, "half", 1, False, False), (1, "c-1", 2, True, True),
    (2, "half+1", 2, True, True)])
def test_bwd_matches_plain_on_card(cuda_device, hd, B, S, H, with_s0, with_dsT):
    S = _LENGTHS[S](_chunk(hd))
    x = _case(B, S, H, hd, seed=hd + S + B, dev=cuda_device, with_s0=with_s0,
              with_dsT=with_dsT)
    n0 = R.wkv6_bwd.launches
    got = R.wkv6_bwd(*x)
    assert R.wkv6_bwd.launches == n0 + 1
    _check(got, R.wkv_bwd_ref(*x))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", R.HEAD_DIMS)
def test_per_batch_row_u(cuda_device, hd):
    x = _case(3, _chunk(hd) + 5, 2, hd, seed=5, dev=cuda_device, u_batched=True)
    got = R.wkv6_bwd(*x)
    assert got[4].shape == (3, 2, hd)
    _check(got, R.wkv_bwd_ref(*x))


@pytest.mark.cuda
def test_training_shape_and_same_bits(cuda_device):
    """RWKV6-7B's training step: 8 x 1024 tokens, 64 heads of 64, no
    initial state; a second call gives the same bits."""
    x = _case(8, 1024, 64, 64, seed=11, dev=cuda_device, with_s0=False, with_dsT=False)
    got = R.wkv6_bwd(*x)
    again = R.wkv6_bwd(*x)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)
    _check(got, R.wkv_bwd_ref(*x))


@pytest.mark.cuda
def test_ops_wkv6_trains_on_card(cuda_device):
    """``ops.wkv6`` under autograd: the forward kernel's bits, the backward
    kernel's gradients, one launch of each; the CPU gives the plain
    version's within ``TOL``."""
    r, k, v, w, u3, s0, dy, _ = _case(2, 40, 2, 64, seed=3, dev=cuda_device, with_dsT=False)
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w, u3[0], s0)]
    f0, b0 = R.wkv6_bhsd.launches, R.wkv6_bwd.launches
    y, _ = ops.wkv6(*leaves)
    grads = torch.autograd.grad((y * dy).sum(), leaves)
    assert (R.wkv6_bhsd.launches - f0, R.wkv6_bwd.launches - b0) == (1, 1)
    y0, _ = ops.wkv6(r, k, v, w, u3[0], s0)
    assert torch.equal(y.detach(), y0)
    want = R.wkv_bwd_ref(r, k, v, w, u3, s0, dy)
    _check([g if i != 4 else g[None] for i, g in enumerate(grads)], want)


@pytest.mark.cuda
def test_card_refuses_what_the_kernel_does_not_take(cuda_device):
    r, k, v, w, u3, s0, dy, _ = _case(1, 4, 1, 16, seed=2, dev=cuda_device)
    with pytest.raises(ValueError, match="dy"):
        R.wkv6_bwd(r, k, v, w, u3, s0, dy[:, :2])
    with pytest.raises(ValueError, match="operands on"):
        R.wkv6_bwd(r, k, v, w, u3, s0, dy.cpu())
