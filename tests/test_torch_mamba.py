"""The port's Mamba mixer (``repro_torch.models.ssm``: ``_causal_conv``,
``mamba_apply`` / ``mamba_decode``, ``softplus``, ``init_mamba``) and its
selective scan (``repro_torch.kernels.mamba``: the CPU path of the wrapper,
the plain version) against the reference's ``models/ssm.py`` on the CPU,
in f32 and bf16.  Inputs come from ``np.random.default_rng``; ``conv_b``,
``D_skip`` and ``dt_b`` are drawn too (the reference's init leaves them
constant, which would not exercise them).  The CUDA kernel itself is held
to the plain version on a card by ``test_torch_mamba_card.py``.

Tolerances, measured on the CPU before they were set:
* the scan: the final state within rtol 1e-6 of ``_ssm_scan`` (XLA may
  contract ``da h + u B`` into a fused multiply-add, the port rounds the
  product and the sum, as the kernel does), y within 1e-6 of max|y| (its
  sum over the state in XLA's order against torch's).
* the mixer, f32: outputs and states within 1e-5 of their max (f32
  products summed in other orders).
* the mixer, bf16: outputs within 2e-2 of max|out| (bf16 rounds at other
  places: XLA computes a fused bf16 chain in f32).  The conv windows are
  the mixer's inputs rounded to bf16: each entry within one bf16 ulp of
  the reference's (an input within noise of a rounding boundary rounds
  the other way: measured 1 of 3,072 entries, in f32 and in bf16 compute).
* softplus: within 2 f32 ulp (1 bf16 ulp), subnormals aside (XLA flushes
  them).
* the kernels' y order (``selective_scan_kernel_order``: a lane's 4
  states summed in order, then folded over the channel's lanes) against
  the plain version's einsum: within 1e-6 of max|y|; the state is the same
  arithmetic, bit-equal.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import ssm as RS
from repro_torch import configs
from repro_torch.kernels import mamba as M
from repro_torch.kernels import ops
from repro_torch.models import ssm as PS

Y_TOL, H_TOL, F32_TOL, BF16_TOL = 1e-6, 1e-6, 1e-5, 2e-2
#: the reference's compute-cast exemptions among Mamba's leaves
KEEP_F32 = {"A_log", "D_skip", "dt_b"}


def _x32():
    """JAX's default 32-bit mode for every call into the reference."""
    return jax.enable_x64(False)


def _cfgs(which: str):
    """(reference config, port config): Jamba ``reduced()`` (d_model 64,
    d_inner 128, d_state 8, dt_rank 4) or a wider cut (d_model 256,
    d_inner 512, d_state 16 as Jamba's, dt_rank 16)."""
    r, p = RC.get("jamba-1.5-large-398b").reduced(), configs.get("jamba-1.5-large-398b").reduced()
    if which == "wide":
        r = dataclasses.replace(r, d_model=256, ssm=dataclasses.replace(r.ssm, d_state=16))
        p = dataclasses.replace(p, d_model=256, ssm=dataclasses.replace(p.ssm, d_state=16))
    return r, p


def _params(cfg, seed: int) -> dict:
    """f32 numpy leaves by the init's laws, with ``conv_b``, ``dt_b``,
    ``D_skip`` and ``A_log`` drawn around their init values."""
    rng = np.random.default_rng(seed)
    D, din, ds, dc = cfg.d_model, cfg.d_inner, cfg.ssm.d_state, cfg.ssm.d_conv
    dtr = cfg.ssm.dt_rank or math.ceil(D / 16)

    def n(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {
        "in_proj": n((D, 2 * din), 1 / math.sqrt(D)),
        "conv_w": n((din, dc), 0.2),
        "conv_b": n((din,), 0.1),
        "x_proj": n((din, dtr + 2 * ds), 1 / math.sqrt(din)),
        "dt_w": n((dtr, din), 1 / math.sqrt(dtr)),
        "dt_b": (-4.6 + n((din,), 1.0)).astype(np.float32),
        "A_log": np.log(np.tile(np.arange(1, ds + 1, dtype=np.float32), (din, 1))
                        * rng.uniform(0.5, 2.0, (din, 1))).astype(np.float32),
        "D_skip": (1.0 + n((din,), 0.3)).astype(np.float32),
        "out_proj": n((din, D), 1 / math.sqrt(din)),
    }


def _cast(p: dict, compute: str):
    """(reference leaves, port leaves) in the compute dtype, the
    ``_KEEP_F32`` leaves f32, as the model casts them."""
    jd, td = (jnp.float32, torch.float32) if compute == "f32" else (jnp.bfloat16, torch.bfloat16)
    with _x32():
        rp = {k: jnp.asarray(v) if k in KEEP_F32 else jnp.asarray(v).astype(jd)
              for k, v in p.items()}
    tp = {k: _t(np.asarray(v)) for k, v in rp.items()}
    assert all(v.dtype == (torch.float32 if k in KEEP_F32 else td) for k, v in tp.items())
    return rp, tp


def _t(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _f(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _bf16_ulps(got, want) -> int:
    """Largest distance in bf16 steps between two bf16 tensors of one
    sign pattern."""
    g = got.contiguous().view(torch.int16).numpy().astype(np.int32)
    w = _t(want).contiguous().view(torch.int16).numpy().astype(np.int32)
    return int(np.abs(g - w).max())


def _share(got, want, tol):
    """Largest difference within ``tol`` of max|want|."""
    g, w = _f(got), _f(want)
    assert g.shape == w.shape
    err = float(np.abs(g - w).max())
    assert err <= tol * float(np.abs(w).max()), f"{err} > {tol} * {float(np.abs(w).max())}"


# --------------------------------------------------------------------------- #
# The scan
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("B,S,din,ds", [(2, 37, 64, 8), (1, 1, 48, 16), (3, 64, 32, 16)])
def test_plain_scan_matches_ssm_scan(B, S, din, ds, with_h0):
    dt, x, A, Bc, Cc, h0 = M.sample_scan_inputs(B, S, din, ds, seed=S + din + ds,
                                                with_h0=with_h0)
    h0n = np.zeros((B, din, ds), np.float32) if h0 is None else h0.numpy()
    with _x32():
        yr, hr = RS._ssm_scan(*(jnp.asarray(a.numpy()) for a in (dt, A, Bc, Cc, x)),
                              jnp.asarray(h0n))
    n0 = M.selective_scan.launches
    y, h = ops.selective_scan(dt, x, A, Bc, Cc, h0)
    assert M.selective_scan.launches == n0  # CPU tensors: the plain version
    assert y.dtype == h.dtype == torch.float32
    assert tuple(y.shape) == (B, S, din) and tuple(h.shape) == (B, din, ds)
    _share(y, yr, Y_TOL)
    _share(h, hr, H_TOL)


def test_scan_writes_the_state_in_place_and_checks_its_operands():
    dt, x, A, Bc, Cc, h0 = M.sample_scan_inputs(2, 5, 16, 8, seed=3)
    want_y, want_h = M.selective_scan_ref(dt, x, A, Bc, Cc, h0)
    cache = h0.clone()
    y, h = ops.selective_scan(dt, x, A, Bc, Cc, cache, state_out=cache)
    assert torch.equal(cache, want_h) and torch.equal(y, want_y)
    # strided B / C rows, as the model slices them from one product
    dbc = torch.cat([torch.zeros(2, 5, 3), Bc, Cc], dim=-1)
    y2, _ = ops.selective_scan(dt, x, A, dbc[..., 3:11], dbc[..., 11:], h0)
    assert torch.equal(y2, want_y)
    with pytest.raises(TypeError, match="float32"):
        ops.selective_scan(dt.double(), x, A, Bc, Cc)
    with pytest.raises(ValueError, match="Bc"):
        ops.selective_scan(dt, x, A, Bc[:, :4], Cc)
    with pytest.raises(ValueError, match="state_out"):
        ops.selective_scan(dt, x, A, Bc, Cc, state_out=torch.zeros(2, 16, 4))


def test_scan_is_differentiable_on_the_cpu():
    """The reference differentiates its ``lax.scan``; on the CPU the port's
    scan trains through :class:`SelectiveScan`, whose backward is the plain
    reverse recurrence (``test_torch_mamba_bwd.py`` holds it gradient for
    gradient)."""
    dt, x, A, Bc, Cc, h0 = M.sample_scan_inputs(2, 9, 8, 8, seed=5)
    x.requires_grad_(True)
    y, h = ops.selective_scan(dt, x, A, Bc, Cc, h0)
    (y.square().sum() + h.sum()).backward()

    def f(xj):
        yj, hj = RS._ssm_scan(*(jnp.asarray(a.numpy()) for a in (dt, A, Bc, Cc)), xj,
                              jnp.asarray(h0.numpy()))
        return jnp.sum(yj * yj) + jnp.sum(hj)

    with _x32():
        want = jax.grad(f)(jnp.asarray(x.detach().numpy()))
    _share(x.grad, want, 1e-5)


@pytest.mark.parametrize("ds", M.D_STATES)
@pytest.mark.parametrize("kernel,S", [("prefill", 40), ("decode", 1)])
def test_kernel_order_emulation_matches_plain(kernel, S, ds):
    """The CUDA kernels' arithmetic in torch (``selective_scan_kernel_order``:
    the prefill and the decode kernel share it): the same state update,
    bit-equal to the plain version's; y summed over a lane's 4 states in
    order, then folded over the channel's ds / 4 lanes, within Y_TOL of
    the plain version's.  Both are also held to an independent loop of
    their own: a rounded product and sum a term."""
    dt, x, A, Bc, Cc, h0 = M.sample_scan_inputs(3, S, 32, ds, seed=11)
    want_y, want_h = M.selective_scan_ref(dt, x, A, Bc, Cc, h0)
    got_y, got_h = M.selective_scan_kernel_order(dt, x, A, Bc, Cc, h0)
    h, ys = h0.clone(), []
    for t in range(S):
        u = dt[:, t] * x[:, t]
        part = []
        for q in range(ds // 4):
            acc = None
            for s in range(4 * q, 4 * q + 4):
                da = torch.exp(dt[:, t] * A[:, s])
                h[:, :, s] = da * h[:, :, s] + u * Bc[:, t, s, None]
                term = h[:, :, s] * Cc[:, t, s, None]
                acc = term if acc is None else acc + term
            part.append(acc)
        ys.append((part[0] + part[2]) + (part[1] + part[3]) if ds == 16 else part[0] + part[1])
    assert torch.equal(h.view(torch.int32), want_h.view(torch.int32))
    assert torch.equal(got_h.view(torch.int32), want_h.view(torch.int32))
    assert torch.equal(torch.stack(ys, 1).view(torch.int32), got_y.view(torch.int32))
    _share(got_y, want_y, Y_TOL)


# --------------------------------------------------------------------------- #
# The mixer's pieces
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(compute, with_state):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = (rng.standard_normal((24, 4)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(24) * 0.1).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32) if with_state else None
    jd = jnp.float32 if compute == "f32" else jnp.bfloat16
    with _x32():
        jx, jw, jb = (jnp.asarray(a).astype(jd) for a in (x, w, b))
        js = None if st is None else jnp.asarray(st).astype(jnp.bfloat16)
        yr, sr = RS._causal_conv(jx, jw, jb, js)
    y, s = PS._causal_conv(_t(jx), _t(jw), _t(jb), None if js is None else _t(js))
    assert y.dtype == s.dtype == (torch.float32 if compute == "f32" else torch.bfloat16)
    assert np.array_equal(_f(s), _f(sr))  # the window: the inputs themselves
    if compute == "f32":
        np.testing.assert_allclose(_f(y), _f(yr), rtol=1e-6, atol=1e-6)
    else:
        _share(y, yr, BF16_TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_softplus_is_logaddexp_beyond_the_torch_threshold(dtype):
    """``jax.nn.softplus`` is ``logaddexp(x, 0)``; torch's ``F.softplus``
    returns ``x`` itself above 20.  The port's agrees with the reference
    at |x| > 20 and elsewhere."""
    xs = np.concatenate([np.linspace(-40, 40, 801), [-1e3, -88, -25, -20.5, 20.5, 25, 88, 1e3]])
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    with _x32():
        jx = jnp.asarray(xs, jnp.float32).astype(jd)
        want = jax.nn.softplus(jx)
    got = PS.softplus(_t(jx))
    assert got.dtype == td
    far = np.abs(xs) > 20
    rtol = 2.4e-7 if dtype == "f32" else 7.9e-3
    assert bool(far.any())
    np.testing.assert_allclose(_f(got), _f(want), rtol=rtol, atol=1e-37)


def test_init_mamba_keeps_the_reference_leaves():
    rcfg, cfg = _cfgs("reduced")
    for dt_name, td in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        with _x32():
            want = jax.eval_shape(lambda k, d=dt_name: RS.init_mamba(k, rcfg, jnp.dtype(d)),
                                  jax.random.PRNGKey(0))
        got = PS.init_mamba(torch.Generator().manual_seed(0), cfg, td, lead=(3,))
        assert set(got) == set(want)
        for k, v in got.items():
            assert tuple(v.shape) == (3,) + tuple(want[k].shape), k
            assert str(v.dtype).split(".")[-1] == str(want[k].dtype), k
        assert torch.equal(got["A_log"][1], torch.log(torch.arange(1.0, 9.0)).expand(128, 8))
        assert bool((got["dt_b"] == torch.tensor(-4.6, dtype=td)).all())
        assert bool((got["conv_b"] == 0).all()) and bool((got["D_skip"] == 1).all())


# --------------------------------------------------------------------------- #
# The mixer: prefill and decode
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("which", ["reduced", "wide"])
def test_mamba_apply_and_decode_match_reference(which, compute):
    rcfg, cfg = _cfgs(which)
    rp, tp = _cast(_params(cfg, seed=21 if which == "reduced" else 22), compute)
    B, S, steps = 2, 19, 4
    rng = np.random.default_rng(23)
    xs = rng.standard_normal((B, S + steps, cfg.d_model)).astype(np.float32)
    jd = jnp.float32 if compute == "f32" else jnp.bfloat16
    tol = F32_TOL if compute == "f32" else BF16_TOL
    with _x32():
        jx = jnp.asarray(xs).astype(jd)
        yr, cr = RS.mamba_apply(rp, jx[:, :S], rcfg, None)
        # the model stores the window in bf16 whatever the compute dtype
        cr = {"conv": cr["conv"].astype(jnp.bfloat16), "ssm": cr["ssm"]}
    tx = _t(jx)
    spec = PS.mamba_cache_spec(cfg, B)
    cache = {k: torch.zeros(s, dtype=d) for k, (s, d) in spec.items()}
    y, st = PS.mamba_apply(tp, tx[:, :S], cfg, state_out=cache["ssm"])
    cache["conv"].copy_(st["conv"])
    assert y.dtype == tx.dtype and cache["conv"].dtype == torch.bfloat16
    _share(y, yr, tol)
    assert _bf16_ulps(cache["conv"], cr["conv"]) <= 1
    _share(cache["ssm"], cr["ssm"], tol)
    for t in range(S, S + steps):
        with _x32():
            yr, nr = RS.mamba_decode(rp, jx[:, t:t + 1], rcfg, cr, None)
            cr = {"conv": nr["conv"].astype(jnp.bfloat16), "ssm": nr["ssm"]}
        ssm_buf = cache["ssm"]
        y, st = PS.mamba_decode(tp, tx[:, t:t + 1], cfg, cache, state_out=cache["ssm"])
        cache["conv"].copy_(st["conv"])
        assert cache["ssm"] is ssm_buf  # in place
        _share(y, yr, tol)
        assert _bf16_ulps(cache["conv"], cr["conv"]) <= 1
        _share(cache["ssm"], cr["ssm"], tol)


def test_mamba_apply_gradients_match_reference():
    """f32, ``reduced()``: every leaf's gradient of a scalar of the
    mixer's output against ``jax.grad`` of the reference's, within 1e-4 of
    the leaf's max."""
    rcfg, cfg = _cfgs("reduced")
    p = _params(cfg, seed=31)
    x = np.random.default_rng(32).standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    y, _ = PS.mamba_apply(tp, torch.from_numpy(x), cfg)
    (y.square().mean()).backward()
    with _x32():
        want = jax.grad(lambda q: jnp.mean(jnp.square(
            RS.mamba_apply(q, jnp.asarray(x), rcfg, None)[0])))(
            {k: jnp.asarray(v) for k, v in p.items()})
    for k, v in tp.items():
        _share(v.grad, want[k], 1e-4)
