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
