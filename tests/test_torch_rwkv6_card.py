"""On a CUDA card: the port's WKV6 kernel (``csrc/rwkv6.cu``) against its
plain version, over every head dim it is built for (16, 32, 64, 128), one
token (a decode step) and long sequences whose chunks divide unevenly,
one (batch, head) pair, strided views, decays near 0 and near 1, a zero
initial state and the state written in place.  Imports neither JAX nor
the reference, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_rwkv6_card.py

Without a card every test skips.

The final state must equal the plain version's bit for bit (both round
the product ``w S``, the product ``k v`` and their sum; the kernel is
built with ``--fmad=false``).  y is summed in another order; it is held
within ``Y_TOL`` of max|y| (an f32 emulation of the kernel's order on the
CPU measured up to 2.6e-7 of max|y| on these input laws)."""

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6 as W

Y_TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _check(got, want):
    (y, s), (yw, sw) = got, want
    torch.cuda.synchronize()
    assert y.dtype == torch.float32 and y.shape == yw.shape and s.shape == sw.shape
    assert bool(torch.isfinite(y).all())
    assert torch.equal(s.view(torch.int32), sw.view(torch.int32)), \
        f"state: {int((s != sw).sum())} entries differ, max {float((s - sw).abs().max())}"
    err = float((y - yw).abs().max())
    assert err <= Y_TOL * float(yw.abs().max()), f"y off by {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("hd", W.HEAD_DIMS)
@pytest.mark.parametrize("B,S,H", [(2, 1, 3), (2, 333, 3), (1, 1000, 1)])
def test_kernel_matches_plain_on_card(cuda_device, hd, B, S, H):
    x = W.sample_wkv_inputs(B, S, H, hd, seed=hd + S, device=cuda_device)
    n0 = W.wkv6_bhsd.launches
    got = ops.wkv6(*x)
    assert W.wkv6_bhsd.launches == n0 + 1
    _check(got, W.wkv_ref(*x))


@pytest.mark.cuda
@pytest.mark.parametrize("w_range", [(1e-6, 1e-3), (0.999, 0.9999), (0.9999, 1.0)])
def test_decays_near_zero_and_one(cuda_device, w_range):
    x = W.sample_wkv_inputs(2, 600, 4, 64, seed=3, device=cuda_device, w_range=w_range)
    _check(ops.wkv6(*x), W.wkv_ref(*x))


@pytest.mark.cuda
def test_kernel_layout_strided_views_zero_state_and_in_place(cuda_device):
    B, S, H, hd = 2, 70, 3, 32
    r, k, v, w, u, s0 = W.sample_wkv_inputs(B, S, H, hd, seed=5, device=cuda_device)
    # the reference's (BH, S, hd) layout
    flat = [t.transpose(1, 2).reshape(B * H, S, hd).contiguous() for t in (r, k, v, w)]
    ub = u.expand(B, H, hd).reshape(B * H, hd).contiguous()
    sb = s0.reshape(B * H, hd, hd)
    _check(W.wkv6_bhsd(*flat, ub, sb), W.wkv6_ref(*flat, ub, sb))
    # every operand a view into a wider buffer
    big = torch.zeros((4, B, S, H + 2, hd), device=cuda_device)
    views = []
    for i, t in enumerate((r, k, v, w)):
        big[i, :, :, 2:] = t
        views.append(big[i, :, :, 2:])
    _check(ops.wkv6(*views, u, s0), W.wkv_ref(r, k, v, w, u, s0))
    # zero state, and the state written into s0 itself
    _check(ops.wkv6(r, k, v, w, u), W.wkv_ref(r, k, v, w, u))
    want = W.wkv_ref(r, k, v, w, u, s0)
    cache = s0.clone()
    got = ops.wkv6(r, k, v, w, u, cache, state_out=cache)
    assert got[1] is cache
    _check(got, want)


@pytest.mark.cuda
def test_graph_replay_and_raises(cuda_device):
    """One decode step per replay of a captured launch (the serving path's
    CUDA graph); a bad head dim raises before any launch."""
    r, k, v, w, u, s0 = W.sample_wkv_inputs(8, 1, 4, 64, seed=9, device=cuda_device)
    state = s0.clone()
    ops.wkv6(r, k, v, w, u, state, state_out=state)  # build and warm up
    state.copy_(s0)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y, _ = ops.wkv6(r, k, v, w, u, state, state_out=state)
    want_s = s0
    for _ in range(3):
        g.replay()
        want_y, want_s = W.wkv_ref(r, k, v, w, u, want_s)
        _check((y, state), (want_y, want_s))
    with pytest.raises(ValueError, match="head dim"):
        ops.wkv6(r[..., :48], k[..., :48], v[..., :48], w[..., :48], u[:, :48])
