"""The port's WKV6 recurrence (``repro_torch.kernels.rwkv6``, the CPU path
of its wrappers: the plain version) against the reference: the Pallas
kernel ``wkv6_bhsd`` in interpret mode, ``kernels/ref.wkv6_ref`` and the
model's ``models/ssm._wkv_scan``, over the reference kernel tests' shapes
(``tests/test_kernels.py:84``) plus one token (S = 1, a decode step) and a
zero initial state; then ``ops.wkv6`` against the reference's ``ops.wkv6``
in the model layout, and the wrappers' dispatch, argument checks and
launch counter.  The CUDA kernel itself is held to the plain version on a
card by ``test_torch_rwkv6_card.py``.

Tolerances, measured on the CPU before they were set:
* y within 2e-6 (abs and rel): the reference sums ``r . (S + u kv)`` in
  XLA's order, the port in torch's (measured up to 4.8e-7, |y| <= 1.7).
* the final state within 1e-6 (abs and rel): XLA's CPU backend contracts
  ``w S + k v`` into a fused multiply-add, the port rounds the product
  and the sum (as the CUDA kernel does, bit for bit), so about a third of
  the entries sit 1 ulp apart (measured up to 6e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ROPS
from repro.kernels import ref as RREF
from repro.kernels.rwkv6 import wkv6_bhsd as pallas_wkv6
from repro.models.ssm import _wkv_scan as reference_scan
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6 as W

#: the reference kernel test's shapes (BH, S, hd, chunk), then one token
#: and a shape whose chunks divide unevenly in the port's kernel
SHAPES = [(2, 64, 16, 16), (1, 128, 32, 64), (3, 32, 64, 32), (2, 96, 16, 96),
          (2, 1, 64, 1), (1, 40, 128, 8)]
Y_TOL, S_TOL = 2e-6, 1e-6


def _x32():
    """JAX's default 32-bit mode for every call into the reference."""
    return jax.enable_x64(False)


def _bhsd_inputs(bh, s, hd, seed, zero_s0=False):
    """The reference kernel test's laws, as numpy f32 arrays."""
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    r, k, v = (normal((bh, s, hd), 0.3) for _ in range(3))
    w = rng.uniform(0.001, 0.9999, (bh, s, hd)).astype(np.float32)
    u = normal((bh, hd), 0.1)
    s0 = np.zeros((bh, hd, hd), np.float32) if zero_s0 else normal((bh, hd, hd), 0.05)
    return r, k, v, w, u, s0


def _close(got: torch.Tensor, want, tol):
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("zero_s0", [False, True])
@pytest.mark.parametrize("bh,s,hd,chunk", SHAPES)
def test_plain_matches_pallas_interpret_and_ref(bh, s, hd, chunk, zero_s0):
    x = _bhsd_inputs(bh, s, hd, bh * 1000 + s * 10 + hd + zero_s0, zero_s0)
    with _x32():
        jx = [jnp.asarray(a) for a in x]
        yp, sp = pallas_wkv6(*jx, chunk=chunk, interpret=True)
        yr, sr = RREF.wkv6_ref(*jx)
    n0 = W.wkv6_bhsd.launches
    y, sT = W.wkv6_bhsd(*(torch.from_numpy(a) for a in x))
    assert W.wkv6_bhsd.launches == n0  # CPU tensors: the plain version
    assert tuple(y.shape) == (bh, s, hd) and tuple(sT.shape) == (bh, hd, hd)
    for want_y, want_s in ((yp, sp), (yr, sr)):
        _close(y, want_y, Y_TOL)
        _close(sT, want_s, S_TOL)
    # the kernel-layout plain version is the same function
    y2, s2 = W.wkv6_ref(*(torch.from_numpy(a) for a in x))
    assert torch.equal(y2, y) and torch.equal(s2, sT)


@pytest.mark.parametrize("B,S,H,hd", [(2, 32, 2, 16), (1, 1, 3, 32), (2, 24, 2, 64)])
def test_model_layout_matches_the_models_scan(B, S, H, hd):
    r, k, v, w, u, s0 = W.sample_wkv_inputs(B, S, H, hd, seed=B + S + H + hd,
                                            w_range=(0.01, 0.999))
    with _x32():
        ym, sm = reference_scan(*(jnp.asarray(t.numpy()) for t in (r, k, v, w, u, s0)))
    y, sT = W.wkv(r, k, v, w, u, s0)
    _close(y, ym, Y_TOL)
    _close(sT, sm, S_TOL)
    y2, s2 = W.wkv_ref(r, k, v, w, u, s0)
    assert torch.equal(y2, y) and torch.equal(s2, sT)


@pytest.mark.parametrize("B,S,H,hd", [(2, 32, 2, 16), (1, 48, 2, 32), (2, 1, 4, 64)])
def test_ops_wkv6_matches_reference_ops(B, S, H, hd):
    """Model layout through both ``ops.wkv6``: the reference transposes to
    (B * H, S, hd) and broadcasts u for its Pallas kernel (interpret
    mode); the port passes the layout through."""
    r, k, v, w, u, s0 = W.sample_wkv_inputs(B, S, H, hd, seed=7 * S + hd)
    with _x32():
        yr, sr = ROPS.wkv6(*(jnp.asarray(t.numpy()) for t in (r, k, v, w, u, s0)),
                           chunk=min(16, S))
    y, sT = ops.wkv6(r, k, v, w, u, s0)
    assert tuple(y.shape) == (B, S, H, hd) and tuple(sT.shape) == (B, H, hd, hd)
    _close(y, yr, Y_TOL)
    _close(sT, sr, S_TOL)


def test_zero_state_default_strided_views_and_state_out():
    """s0 None is a zero state; strided (non-contiguous) views give the
    contiguous result; ``state_out`` receives the final state, also when
    it is ``s0`` itself (the serving cache, in place)."""
    B, S, H, hd = 2, 12, 3, 16
    r, k, v, w, u, s0 = W.sample_wkv_inputs(B, S, H, hd, seed=3)
    y0, st0 = W.wkv(r, k, v, w, u, torch.zeros_like(s0))
    y1, st1 = W.wkv(r, k, v, w, u)
    assert torch.equal(y0, y1) and torch.equal(st0, st1)
    # every operand a view into a wider buffer
    big = torch.zeros((4, B, S, H + 1, hd))
    views = []
    for i, t in enumerate((r, k, v, w)):
        big[i, :, :, 1:] = t
        views.append(big[i, :, :, 1:])
    assert not views[0].is_contiguous()
    ub = torch.zeros((H, 2 * hd))
    ub[:, hd:] = u
    y2, st2 = W.wkv(*views, ub[:, hd:], s0)
    y3, st3 = W.wkv(r, k, v, w, u, s0)
    assert torch.equal(y2, y3) and torch.equal(st2, st3)
    cache = s0.clone()
    y4, st4 = W.wkv(r, k, v, w, u, cache, state_out=cache)
    assert st4 is cache and torch.equal(cache, st3) and torch.equal(y4, y3)
    out = torch.empty_like(s0)
    _, st5 = ops.wkv6(r, k, v, w, u, s0, state_out=out)
    assert st5 is out and torch.equal(out, st3)


def test_decode_steps_chain_to_the_prefill():
    """S tokens at once equal S one-token calls, each from the last state:
    the decode path's state carries exactly."""
    B, S, H, hd = 2, 6, 2, 32
    r, k, v, w, u, s0 = W.sample_wkv_inputs(B, S, H, hd, seed=11)
    y, sT = W.wkv(r, k, v, w, u, s0)
    state = s0.clone()
    ys = []
    for t in range(S):
        yt, _ = W.wkv(r[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1], w[:, t:t + 1], u, state,
                      state_out=state)
        ys.append(yt)
    assert torch.equal(torch.cat(ys, dim=1), y) and torch.equal(state, sT)


def test_argument_checks():
    r, k, v, w, u, s0 = W.sample_wkv_inputs(1, 4, 2, 16, seed=0)
    with pytest.raises(ValueError, match="head dim"):
        W.wkv(r[..., :8], k[..., :8], v[..., :8], w[..., :8], u[:, :8])
    with pytest.raises(TypeError, match="float32"):
        W.wkv(r.to(torch.bfloat16), k, v, w, u)
    with pytest.raises(TypeError, match="float32"):
        W.wkv(r, k, v, w, u, s0.double())
    with pytest.raises(ValueError, match="does not match"):
        W.wkv(r, k[:, :3], v, w, u)
    with pytest.raises(ValueError, match="broadcast"):
        W.wkv(r, k, v, w, torch.zeros(3, 16))
    with pytest.raises(ValueError, match="shape"):
        W.wkv(r, k, v, w, u, s0[:, :1])
    with pytest.raises(ValueError, match="contiguous"):
        W.wkv(r.transpose(2, 3).contiguous().transpose(2, 3), k, v, w, u)
    with pytest.raises(ValueError, match="empty"):
        W.wkv(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u)
    with pytest.raises(TypeError, match="3-D"):
        W.wkv6_bhsd(r, k, v, w, u, s0)
    with pytest.raises(TypeError, match="2-D"):
        W.wkv(r, k, v, w, u[None])


def test_sample_inputs_follow_the_reference_laws():
    r, k, v, w, u, s0 = W.sample_wkv_inputs(2, 64, 4, 32, seed=1)
    assert all(t.dtype == torch.float32 for t in (r, k, v, w, u, s0))
    assert float(w.min()) >= 0.001 and float(w.max()) <= 0.9999
    assert 0.25 < float(r.std()) < 0.35 and 0.08 < float(u.std()) < 0.12
    a = W.sample_wkv_inputs(2, 64, 4, 32, seed=1)
    assert all(torch.equal(x, y) for x, y in zip(a, (r, k, v, w, u, s0)))


def test_tile_rows_argument():
    """``tile_rows`` names a built tile of the head dim; on the CPU the
    plain version runs whatever tile is named."""
    r, k, v, w, u, s0 = W.sample_wkv_inputs(1, 3, 2, 64, seed=0)
    assert all(hd in W.TILE_ROWS for hd in W.HEAD_DIMS)
    y, sT = W.wkv(r, k, v, w, u, s0, tile_rows=8)
    y0, s0_ = W.wkv(r, k, v, w, u, s0)
    assert torch.equal(y, y0) and torch.equal(sT, s0_)
    with pytest.raises(ValueError, match="tile_rows"):
        W.wkv(r, k, v, w, u, s0, tile_rows=2)


# --------------------------------------------------------------------------- #
# The card kernel's arithmetic, emulated on the CPU
# --------------------------------------------------------------------------- #
def _fma(a, b, c):
    """f32 fused multiply-add (the product exact in f64, one f64 rounding
    of the sum, then f32)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _warp_rows(p):
    """``reduce_warp_rows`` and the cross-warp sum: p (BH, NW, W, NC, 4),
    each lane's four column sums (lane (w, gl, c): warp w, row group gl
    of the warp, column group c) -> (BH, HD): halving exchanges between
    lanes gl and gl ^ bit (the lane whose bit is set keeping the upper
    half), a butterfly over the row groups left, then the warps' sums
    added in warp order."""
    W = p.shape[2]
    gl = np.arange(W)
    vals = [p[..., q] for q in range(4)]
    half, bit = 2, 1
    while half >= 1 and bit < W:
        hi = ((gl & bit) != 0)[:, None]
        vals = [np.where(hi, vals[q + half], vals[q])
                + np.where(hi, vals[q], vals[q + half])[..., gl ^ bit, :] for q in range(half)]
        half, bit = half // 2, bit * 2
    bit = 4
    while bit < W:
        vals[0] = vals[0] + vals[0][..., gl ^ bit, :]
        bit *= 2
    part = np.empty(p.shape[:2] + p.shape[3:], np.float32)  # (BH, NW, NC, 4)
    for g in range(min(W, 4)):
        off, h, b = 0, 2, 1
        while h >= 1 and b < W:
            off += h if g & b else 0
            h, b = h // 2, b * 2
        for q, x in enumerate(vals):
            part[..., off + q] = x[:, :, g]
    part = part.reshape(p.shape[0], p.shape[1], -1)
    y = part[:, 0]
    for w in range(1, p.shape[1]):
        y = y + part[:, w]
    return y


def _card_wkv(r, k, v, w, u, s0, TR):
    """The CUDA kernels' arithmetic in numpy, in the kernel layout ((BH, S,
    hd) f32, u (BH, hd), s0 (BH, hd, hd)), threads (g, c) owning TR x 4
    tiles, column groups the fast index: the chunked kernel for S > 1
    (bonus dots over P lanes of CPL channels and a butterfly, y = fma(c,
    v, sum of the warps' column sums)), the one-token kernel for S == 1
    (each tile's rows of the bonus folded into its column sums)."""
    BH, S, hd = r.shape
    G, NC = hd // TR, hd // 4
    W = 32 // NC
    NT = G * NC
    room = 14336 // ((8 + NT // 32) * hd)  # Tile::kChunk
    CH = next((c for c in (1024 // hd, 32, 16, 8) if room >= c), 4)
    P = max(1, min(32, hd // 4, NT // CH))
    st = s0.copy()
    y = np.empty_like(r)
    for t in range(S):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        tile = st.reshape(BH, G, TR, NC, 4)
        rows = rt.reshape(BH, G, TR)
        p = np.zeros((BH, G, NC, 4), np.float32)
        for a in range(TR):
            p = _fma(rows[:, :, a, None, None], tile[:, :, a], p)
        uk = (u * kt).astype(np.float32)
        if S == 1:
            d = np.zeros((BH, G), np.float32)
            for a in range(TR):
                d = _fma(rows[:, :, a], uk.reshape(BH, G, TR)[:, :, a], d)
            p = _fma(d[:, :, None, None], vt.reshape(BH, 1, NC, 4), p)
            y[:, t] = _warp_rows(p.reshape(BH, G // W, W, NC, 4))
        else:
            d = np.zeros((BH, P), np.float32)
            for m in range(hd // P):
                d = _fma(rt.reshape(BH, P, -1)[:, :, m], uk.reshape(BH, P, -1)[:, :, m], d)
            lanes, off = np.arange(P), 1
            while off < P:
                d = d + d[:, lanes ^ off]
                off *= 2
            sums = _warp_rows(p.reshape(BH, G // W, W, NC, 4))
            y[:, t] = _fma(d[:, :1], vt, sums)
        st = ((wt[:, :, None] * st).astype(np.float32)
              + (kt[:, :, None] * vt[:, None, :]).astype(np.float32))
    return y, st


@pytest.mark.parametrize("S", [1, 37])
@pytest.mark.parametrize("hd,tr", [(hd, tr) for hd in W.HEAD_DIMS for tr in W.TILE_ROWS[hd]])
def test_card_arithmetic_emulated_within_the_card_tolerance(hd, tr, S):
    """The kernels' summation order (tiles of ``tr`` rows, the warp
    reduction's exchanges, the bonus) emulated in numpy: the state is the
    plain version's bit for bit, y within the card tests' 1e-5 of max|y|
    (measured here up to ~3e-7)."""
    r, k, v, w, u, s0 = (t.numpy() for t in W.sample_wkv_inputs(3, S, 2, hd, seed=hd + S))
    flat = [a.transpose(0, 2, 1, 3).reshape(6, S, hd) for a in (r, k, v, w)]
    ub = np.broadcast_to(u, (3, 2, hd)).reshape(6, hd)
    y, st = _card_wkv(*flat, ub, s0.reshape(6, hd, hd), tr)
    yw, sw = W.wkv6_ref(*(torch.from_numpy(np.ascontiguousarray(a)) for a in flat),
                        torch.from_numpy(ub.copy()), torch.from_numpy(s0.reshape(6, hd, hd)))
    assert np.array_equal(st.view(np.int32), sw.numpy().view(np.int32))
    err = float(np.abs(y - yw.numpy()).max())
    assert err <= 1e-5 * float(yw.abs().max()), err
