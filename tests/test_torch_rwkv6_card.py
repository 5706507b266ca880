"""On a CUDA card: the port's WKV6 kernels (``csrc/rwkv6.cu``: the
chunked prefill kernel and the one-token decode kernel) against their
plain version, over every head dim they are built for (16, 32, 64, 128)
and every built tile, one token (a decode step, also in place at every
head dim) and long sequences whose chunks divide unevenly, sequences that
end on and beside a staging chunk's edge, more (batch, head) blocks than
fit the card at once, one (batch, head) pair, strided and unaligned
views, decays near 0 and near 1, a zero initial state and the state
written in place.  Imports neither JAX nor
the reference, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_rwkv6_card.py

Without a card every test skips.

The final state must equal the plain version's bit for bit (both round
the product ``w S``, the product ``k v`` and their sum; the kernel is
built with ``--fmad=false``).  y is summed in another order; it is held
within ``Y_TOL`` of max|y| (the f32 emulation of the kernels' order in
``test_torch_rwkv6.py`` measures up to 3.0e-7 of max|y| on these input
laws)."""

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


def _chunk(hd, tile_rows):
    """Tokens a staging chunk of the prefill kernel holds (``Tile::kChunk``
    in ``csrc/rwkv6.cu``)."""
    warps = (hd // tile_rows) * (hd // 4) // 32
    room = 14336 // ((8 + warps) * hd)
    return next((c for c in (1024 // hd, 32, 16, 8) if room >= c), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", W.HEAD_DIMS)
def test_one_token_variant_in_place(cuda_device, hd):
    """A decode step (S == 1, the one-token kernel) with the state written
    into s0 itself."""
    r, k, v, w, u, s0 = W.sample_wkv_inputs(3, 1, 5, hd, seed=30 + hd, device=cuda_device)
    want = W.wkv_ref(r, k, v, w, u, s0)
    state = s0.clone()
    n0 = W.wkv6_bhsd.launches
    got = ops.wkv6(r, k, v, w, u, state, state_out=state)
    assert W.wkv6_bhsd.launches == n0 + 1
    assert got[1] is state
    _check(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 40])
def test_more_heads_than_one_wave(cuda_device, S):
    """B 16 x H 64 = 1024 (batch, head) blocks, more than the card holds
    at once: nothing may assume every block is resident."""
    x = W.sample_wkv_inputs(16, S, 64, 64, seed=S, device=cuda_device)
    n0 = W.wkv6_bhsd.launches
    got = ops.wkv6(*x)
    assert W.wkv6_bhsd.launches == n0 + 1
    _check(got, W.wkv_ref(*x))


@pytest.mark.cuda
@pytest.mark.parametrize("hd,tile_rows", [(64, 4), (64, 8), (128, 8)])
@pytest.mark.parametrize("edge", ["1", "2", "chunk-1", "chunk", "chunk+1", "333"])
def test_staging_ring_edges(cuda_device, hd, tile_rows, edge):
    """Sequences that end on and beside a chunk's edge, for every built
    tile of hd 64 and 128."""
    ch = _chunk(hd, tile_rows)
    S = {"1": 1, "2": 2, "chunk-1": ch - 1, "chunk": ch, "chunk+1": ch + 1, "333": 333}[edge]
    x = W.sample_wkv_inputs(2, S, 3, hd, seed=S + tile_rows, device=cuda_device)
    n0 = W.wkv6_bhsd.launches
    got = ops.wkv6(*x, tile_rows=tile_rows)
    assert W.wkv6_bhsd.launches == n0 + 1
    _check(got, W.wkv_ref(*x))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 40])
def test_unaligned_views_take_four_byte_copies(cuda_device, S):
    """Operands that start one float past a 16-byte boundary: the kernels
    move 4 bytes at a time and give the same bits."""
    B, H, hd = 2, 3, 64
    r, k, v, w, u, s0 = W.sample_wkv_inputs(B, S, H, hd, seed=60 + S, device=cuda_device)
    big = torch.zeros((4, B, S, H, hd + 1), device=cuda_device)
    views = []
    for i, t in enumerate((r, k, v, w)):
        big[i, ..., 1:] = t
        views.append(big[i, ..., 1:])
    assert views[0].data_ptr() % 16 != 0
    n0 = W.wkv6_bhsd.launches
    got = ops.wkv6(*views, u, s0)
    assert W.wkv6_bhsd.launches == n0 + 1
    _check(got, W.wkv_ref(r, k, v, w, u, s0))


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
