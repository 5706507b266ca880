"""The backward of the port's WKV recurrence on the CPU
(``repro_torch.kernels.rwkv6``: :func:`wkv_bwd_ref`, the :class:`WKV`
Function behind ``ops.wkv6``) against ``jax.grad`` of the reference's
``models/ssm._wkv_scan``, against torch autograd through the plain forward
:func:`wkv_ref`, and RWKV6-7B ``reduced()``'s ``loss_fn`` gradients
against the reference's ``jax.grad``, leaf for leaf.  Inputs come from
``np.random.default_rng``; the model's ``u``, ``w0``, ``mu`` and ``ln``
are drawn too (the reference's init leaves ``u`` and ``w0`` zero, so du
and dw would never be exercised).  The CUDA kernel is held to
:func:`wkv_bwd_ref` on a card by ``test_torch_rwkv6_bwd_card.py``.

Tolerances, measured on the CPU before they were set:
* each gradient against ``jax.grad`` of ``_wkv_scan``: within 1e-5 of
  the gradient's max (measured up to 3.1e-7: XLA contracts the state
  update into an FMA and sums the einsums in its order).
* against torch autograd through :func:`wkv_ref`: within 1e-6 of the
  max (measured up to 3.1e-7, the reductions in other orders); ds0, the
  elementwise chain of G with autograd's roundings, bit-equal.
* the model, f32 compute: the loss rtol 1e-5 and every gradient leaf
  within 1e-4 of the leaf's max (measured up to 9.4e-6; the bound of
  ``test_torch_train.py``'s SmolLM gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.launch.steps import build_model as r_build_model
from repro.models import ssm as RS
from repro.models.layers import RuntimeFlags as RFlags
from repro_torch import configs
from repro_torch.checkpoint.store import flatten_with_keys, map_with_keys
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6 as R
from repro_torch.models import LanguageModel, RuntimeFlags, params_from_jax

REF_TOL, AUTOGRAD_TOL, LOSS_RTOL, LEAF_TOL = 1e-5, 1e-6, 1e-5, 1e-4
NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")

CASES = [  # (B, S, H, hd, with s0, with dsT)
    (2, 9, 3, 16, True, True),
    (2, 1, 2, 16, True, False),  # one token, a nonzero s0
    (1, 17, 2, 32, True, False),
    (3, 6, 1, 64, False, True),
    (2, 5, 2, 16, False, False),
]


def _inputs(B, S, H, hd, seed):
    """The WKV inputs (the reference kernel test's laws) and the upstream
    gradients ``gy`` ``(B, S, H, hd)`` and ``gs`` ``(B, H, hd, hd)``, numpy
    f32."""
    r, k, v, w, u, s0 = (x.numpy() for x in R.sample_wkv_inputs(B, S, H, hd, seed))
    rng = np.random.default_rng(seed + 1000)
    gy = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    gs = (rng.standard_normal((B, H, hd, hd)) * 0.1).astype(np.float32)
    return (r, k, v, w, u, s0), gy, gs


def _jax_grads(x, gy, gs, with_s0, with_dsT):
    r, k, v, w, u, s0 = (jnp.asarray(a) for a in x)
    if not with_s0:
        s0 = jnp.zeros_like(s0)

    def loss(r, k, v, w, u, s0):
        y, sT = RS._wkv_scan(r, k, v, w, u, s0)
        out = jnp.sum(y * gy)
        return out + jnp.sum(sT * gs) if with_dsT else out

    with jax.enable_x64(True):
        g = jax.grad(loss, argnums=tuple(range(6)))(r, k, v, w, u, s0)
    return [np.asarray(a) for a in g]


def _close(got, want, tol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape and got.dtype == np.float32, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"{what}: off by {err} (max {scale})"


@pytest.mark.parametrize("B,S,H,hd,with_s0,with_dsT", CASES)
def test_bwd_ref_matches_jax_grad(B, S, H, hd, with_s0, with_dsT):
    x, gy, gs = _inputs(B, S, H, hd, seed=B * 100 + S)
    want = _jax_grads(x, gy, gs, with_s0, with_dsT)
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in x)
    got = R.wkv_bwd_ref(r, k, v, w, u[None], s0 if with_s0 else None, torch.from_numpy(gy),
                        torch.from_numpy(gs) if with_dsT else None)
    assert (got[5] is None) == (not with_s0)
    for name, g, wv in zip(NAMES, got, want):
        if g is None:
            continue
        _close(g.reshape(wv.shape) if name == "du" else g, wv, REF_TOL, name)


@pytest.mark.parametrize("B,S,H,hd,with_s0,with_dsT", CASES)
def test_bwd_ref_matches_autograd_of_the_plain_forward(B, S, H, hd, with_s0, with_dsT):
    x, gy, gs = _inputs(B, S, H, hd, seed=B * 10 + S)
    r, k, v, w, u, s0 = (torch.from_numpy(a).requires_grad_(True) for a in x)
    y, sT = R.wkv_ref(r, k, v, w, u, s0 if with_s0 else None)
    loss = (y * torch.from_numpy(gy)).sum()
    if with_dsT:
        loss = loss + (sT * torch.from_numpy(gs)).sum()
    want = torch.autograd.grad(loss, (r, k, v, w, u, s0), allow_unused=True)
    got = R.wkv_bwd_ref(*(t.detach() for t in (r, k, v, w)), u.detach()[None],
                        s0.detach() if with_s0 else None, torch.from_numpy(gy),
                        torch.from_numpy(gs) if with_dsT else None)
    for name, g, wv in zip(NAMES, got, want):
        if name == "ds0" and not with_s0:
            continue
        if wv is None:  # w of a lone token reaches only the unused final state
            assert name == "dw" and not with_dsT and not bool(g.any())
            continue
        _close(g.reshape(wv.shape), wv.numpy(), AUTOGRAD_TOL, name)
    if with_s0:  # G's elementwise chain, the same roundings as autograd's
        assert torch.equal(got[5], want[5])


def test_ops_wkv6_trains_through_the_function():
    """Under autograd ``ops.wkv6`` runs the :class:`WKV` Function: the
    forward's bits, the backward :func:`wkv_bwd_ref`'s, no kernel launch on
    the CPU; ``state_out`` still receives the final state."""
    x, gy, gs = _inputs(2, 7, 2, 16, seed=5)
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in x)
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w, u, s0)]
    state = torch.zeros_like(s0)
    n0, b0 = R.wkv6_bhsd.launches, R.wkv6_bwd.launches
    y, sT = ops.wkv6(*leaves, state_out=state)
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == "WKVBackward"
    y0, s_0 = R.wkv_ref(r, k, v, w, u, s0)
    assert torch.equal(y.detach(), y0) and torch.equal(state, s_0)
    loss = (y * torch.from_numpy(gy)).sum() + (sT * torch.from_numpy(gs)).sum()
    grads = torch.autograd.grad(loss, leaves)
    want = R.wkv_bwd_ref(r, k, v, w, u[None], s0, torch.from_numpy(gy), torch.from_numpy(gs))
    for name, g, wv in zip(NAMES, grads, want):
        assert torch.equal(g, wv.reshape(g.shape)), name
    assert (R.wkv6_bhsd.launches, R.wkv6_bwd.launches) == (n0, b0)


def test_bwd_wrapper_checks_its_inputs():
    x, gy, _ = _inputs(1, 3, 1, 16, seed=2)
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in x)
    with pytest.raises(ValueError, match="dy"):
        R.wkv6_bwd(r, k, v, w, u[None], s0, torch.from_numpy(gy)[:, :2])
    with pytest.raises(TypeError, match="float32"):
        R.wkv6_bwd(r.double(), k, v, w, u[None], s0, torch.from_numpy(gy))


# --------------------------------------------------------------------------- #
# The model: rwkv6-7b.reduced(), loss_fn against jax.grad
# --------------------------------------------------------------------------- #
def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _seeded_rwkv_params(rp, seed):
    """The reference's init with every time mix's ``u``, ``w0``, ``mu`` and
    ``ln`` drawn from ``seed`` (numpy leaves, the reference's tree)."""
    rng = np.random.default_rng(seed)
    tree = _np_tree(rp)
    for blk in tree["blocks"]:
        tm = blk["mixer"]
        tm["u"] = (rng.standard_normal(tm["u"].shape) * 0.5).astype(np.float32)
        tm["w0"] = (rng.standard_normal(tm["w0"].shape) * 0.5 - 0.5).astype(np.float32)
        tm["mu"] = rng.uniform(0.0, 1.0, tm["mu"].shape).astype(np.float32)
        tm["ln"] = rng.uniform(0.5, 1.5, tm["ln"].shape).astype(np.float32)
        blk["mlp"]["mu"] = rng.uniform(0.0, 1.0, blk["mlp"]["mu"].shape).astype(np.float32)
    return tree


def test_rwkv_loss_gradients_match_jax_grad():
    rcfg, cfg = RC.get("rwkv6-7b").reduced(), configs.get("rwkv6-7b").reduced()
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    rm = r_build_model(rcfg, mesh=None, flags=RFlags(compute_dtype=jnp.float32))[0]
    tree = _seeded_rwkv_params(rm.init(jax.random.PRNGKey(0)), seed=9)
    with jax.enable_x64(True):
        jp = jax.tree.map(jnp.asarray, tree)
        want_loss, wg = jax.value_and_grad(
            lambda p: rm.loss_fn(p, {"tokens": jnp.asarray(toks)})[0])(jp)
    want = {k: np.asarray(v) for k, v in flatten_with_keys(_np_tree(wg)).items()}
    pm = LanguageModel(cfg, RuntimeFlags(compute_dtype=torch.float32))
    live = map_with_keys(lambda _, p: p.detach().requires_grad_(True),
                         params_from_jax(tree, device="cpu"))
    loss, _ = pm.loss_fn(live, {"tokens": torch.from_numpy(toks)})
    flat = flatten_with_keys(live)
    got = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_RTOL)
    assert list(got) == list(want)
    for key, w in want.items():
        _close(got[key], w, LEAF_TOL, key)
    for key in ("blocks/0/mixer/u", "blocks/0/mixer/w0", "blocks/0/mixer/mu"):
        assert np.abs(want[key]).max() > 0, key  # the bonus and decays are exercised
