"""The backward of the port's selective scan on the CPU
(``repro_torch.kernels.mamba``: :func:`selective_scan_bwd_ref`, the
:class:`SelectiveScan` Function behind ``ops.selective_scan``) against
``jax.grad`` of the reference's ``models/ssm._ssm_scan``, against torch
autograd through the plain forward :func:`selective_scan_ref`, and
Jamba-1.5-Large ``reduced()``'s ``loss_fn`` gradients against the
reference's ``jax.grad``, leaf for leaf.  Inputs come from
``np.random.default_rng``.  The CUDA kernel is held to
:func:`selective_scan_bwd_ref` on a card by
``test_torch_mamba_bwd_card.py``.

Tolerances, measured on the CPU before they were set:
* each gradient against ``jax.grad`` of ``_ssm_scan``: within 1e-5 of
  the gradient's max (measured up to 3.4e-7: XLA contracts ``da h + u
  B`` into an FMA and sums the einsums in its order).
* against torch autograd through :func:`selective_scan_ref`: within 1e-6
  of the max (measured up to 2.1e-7, the reductions in other orders);
  dh0, an elementwise chain with autograd's roundings, bit-equal.
* the model, f32 compute: the loss rtol 1e-5 and every gradient leaf
  within 1e-4 of the leaf's max (measured up to 6.8e-6; the bound of
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
from repro_torch.kernels import mamba as M
from repro_torch.kernels import ops
from repro_torch.models import LanguageModel, RuntimeFlags, params_from_jax

REF_TOL, AUTOGRAD_TOL, LOSS_RTOL, LEAF_TOL = 1e-5, 1e-6, 1e-5, 1e-4
NAMES = ("ddt", "dx", "dA", "dB", "dC", "dh0")

CASES = [  # (B, S, din, ds, with h0, with dhT)
    (2, 19, 24, 8, True, True),
    (1, 1, 40, 8, True, False),  # one token, a nonzero h0
    (2, 33, 16, 16, True, False),
    (3, 9, 8, 16, False, True),
    (2, 12, 32, 16, False, False),
]


def _inputs(B, S, din, ds, seed):
    """The scan's inputs (Mamba's laws) and the upstream gradients ``gy``
    ``(B, S, din)`` and ``gh`` ``(B, din, ds)``, numpy f32."""
    x = [t.numpy() for t in M.sample_scan_inputs(B, S, din, ds, seed)]
    rng = np.random.default_rng(seed + 1000)
    gy = rng.standard_normal((B, S, din)).astype(np.float32)
    gh = (rng.standard_normal((B, din, ds)) * 0.1).astype(np.float32)
    return x, gy, gh


def _close(got, want, tol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape and got.dtype == np.float32, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"{what}: off by {err} (max {scale})"


@pytest.mark.parametrize("B,S,din,ds,with_h0,with_dhT", CASES)
def test_bwd_ref_matches_jax_grad(B, S, din, ds, with_h0, with_dhT):
    (dt, x, A, Bc, Cc, h0), gy, gh = _inputs(B, S, din, ds, seed=B * 100 + S + ds)
    if not with_h0:
        h0 = np.zeros_like(h0)

    def loss(dt, A, Bc, Cc, x, h0):
        y, h = RS._ssm_scan(dt, A, Bc, Cc, x, h0)
        out = jnp.sum(y * gy)
        return out + jnp.sum(h * gh) if with_dhT else out

    with jax.enable_x64(True):
        gdt, gA, gB, gC, gx, gh0 = jax.grad(loss, argnums=tuple(range(6)))(
            *(jnp.asarray(a) for a in (dt, A, Bc, Cc, x, h0)))
    want = [np.asarray(a) for a in (gdt, gx, gA, gB, gC, gh0)]
    got = M.selective_scan_bwd_ref(*(torch.from_numpy(a) for a in (dt, x, A, Bc, Cc)),
                                   torch.from_numpy(h0) if with_h0 else None,
                                   torch.from_numpy(gy),
                                   torch.from_numpy(gh) if with_dhT else None)
    assert (got[5] is None) == (not with_h0)
    for name, g, wv in zip(NAMES, got, want):
        if g is not None:
            _close(g, wv, REF_TOL, name)


@pytest.mark.parametrize("B,S,din,ds,with_h0,with_dhT", CASES)
def test_bwd_ref_matches_autograd_of_the_plain_forward(B, S, din, ds, with_h0, with_dhT):
    (dt, x, A, Bc, Cc, h0), gy, gh = _inputs(B, S, din, ds, seed=B * 10 + S + ds)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (dt, x, A, Bc, Cc, h0)]
    y, h = M.selective_scan_ref(*leaves[:5], leaves[5] if with_h0 else None)
    loss = (y * torch.from_numpy(gy)).sum()
    if with_dhT:
        loss = loss + (h * torch.from_numpy(gh)).sum()
    want = torch.autograd.grad(loss, leaves, allow_unused=True)
    got = M.selective_scan_bwd_ref(*(t.detach() for t in leaves[:5]),
                                   leaves[5].detach() if with_h0 else None,
                                   torch.from_numpy(gy),
                                   torch.from_numpy(gh) if with_dhT else None)
    for name, g, wv in zip(NAMES, got, want):
        if name == "dh0" and not with_h0:
            continue
        _close(g, wv.numpy(), AUTOGRAD_TOL, name)
    if with_h0:  # the carried gradient's elementwise chain, autograd's roundings
        assert torch.equal(got[5], want[5])


def test_ops_selective_scan_trains_through_the_function():
    """Under autograd ``ops.selective_scan`` runs the :class:`SelectiveScan`
    Function: the forward's bits, the backward
    :func:`selective_scan_bwd_ref`'s, no kernel launch on the CPU;
    ``state_out`` still receives the final state."""
    (dt, x, A, Bc, Cc, h0), gy, gh = _inputs(2, 11, 24, 16, seed=7)
    plain = [torch.from_numpy(a) for a in (dt, x, A, Bc, Cc, h0)]
    leaves = [t.clone().requires_grad_(True) for t in plain]
    state = torch.zeros_like(plain[5])
    n0, b0 = M.selective_scan.launches, M.selective_scan_bwd.launches
    y, h = ops.selective_scan(*leaves, state_out=state)
    assert type(y.grad_fn).__name__ == "SelectiveScanBackward"
    y0, h_0 = M.selective_scan_ref(*plain)
    assert torch.equal(y.detach(), y0) and torch.equal(state, h_0)
    loss = (y * torch.from_numpy(gy)).sum() + (h * torch.from_numpy(gh)).sum()
    grads = torch.autograd.grad(loss, leaves)
    want = M.selective_scan_bwd_ref(*plain, torch.from_numpy(gy), torch.from_numpy(gh))
    for name, g, wv in zip(NAMES, grads, want):
        assert torch.equal(g, wv), name
    assert (M.selective_scan.launches, M.selective_scan_bwd.launches) == (n0, b0)


def test_bwd_wrapper_checks_its_inputs():
    (dt, x, A, Bc, Cc, h0), gy, _ = _inputs(1, 3, 8, 8, seed=2)
    t = [torch.from_numpy(a) for a in (dt, x, A, Bc, Cc, h0)]
    with pytest.raises(ValueError, match="dy"):
        M.selective_scan_bwd(*t, torch.from_numpy(gy)[:, :2])
    with pytest.raises(TypeError, match="float32"):
        M.selective_scan_bwd(t[0].double(), *t[1:], torch.from_numpy(gy))


# --------------------------------------------------------------------------- #
# The model: Jamba reduced(), loss_fn against jax.grad
# --------------------------------------------------------------------------- #
def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def test_jamba_loss_gradients_match_jax_grad():
    """Every leaf of Jamba ``reduced()`` (7 Mamba layers and an attention
    layer, dense and MoE MLPs, f32), the Mamba leaves' ``dt_b``,
    ``D_skip`` and ``conv_b`` drawn so that each path carries a gradient."""
    name = "jamba-1.5-large-398b"
    rcfg, cfg = RC.get(name).reduced(), configs.get(name).reduced()
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    rm = r_build_model(rcfg, mesh=None, flags=RFlags(compute_dtype=jnp.float32))[0]
    tree = _np_tree(rm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(8)
    for blk in tree["blocks"]:
        mx = blk["mixer"]
        if "dt_b" in mx:
            mx["dt_b"] = (mx["dt_b"] + rng.standard_normal(mx["dt_b"].shape)).astype(np.float32)
            mx["D_skip"] = (1 + 0.3 * rng.standard_normal(mx["D_skip"].shape)).astype(np.float32)
            mx["conv_b"] = (0.1 * rng.standard_normal(mx["conv_b"].shape)).astype(np.float32)
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
    assert any("A_log" in k for k in want) and all(
        np.abs(w).max() > 0 for k, w in want.items() if "A_log" in k)
