"""The port's MoE layer (``repro_torch.models.moe``) against the
reference's ``repro.models.moe.moe_apply(p, x, cfg, None)`` on the CPU:
outputs, the routing (``expert_ids`` and the keep mask) and the aux loss,
in f32 and bf16 compute, on Qwen3-30B-A3B's and Arctic-480B's
``reduced()`` configs (Arctic with its dense residual), on a width case
(d_model 2048, d_ff 768, top-8 of 16 experts), at a decode-sized T = 8
(Qwen3's 128 experts, top-8, at the reduced width: C = 4), with capacity
factors of 0.5 (tokens drop) and 2, and with the ``moe_capacity_factor``
override.  Weights are the reference's
``init_moe``; activations come from numpy.  The reference's
``expert_ids`` are read off its own ``jax.lax.top_k`` call; its keep mask
is rebuilt from them in numpy (stable sort, rank within the expert,
``rank < C``).

Tolerances, measured on the CPU before they were set:
* f32: the routing equal (ids and keep mask); the output within 1e-5 of
  max|y| (measured up to 8.1e-7) and aux within rtol 1e-6 (measured up
  to 1.2e-7).  XLA's and torch's f32 products sum in other orders.
* bf16: routing may differ at a near tie of two router probabilities
  (the router is f32 on both sides, over the same bf16 activations, so
  only the summation order differs); at most 1% of the (token, choice)
  pairs may differ (measured: none of 1,600).  On the tokens whose whole
  routing agrees the output is within 2e-2 of max|y| (measured up to
  8.4e-3: bf16 rounds the products and the adds); aux rtol 1e-6
  (measured up to 1.2e-7).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import moe as RM
from repro.models.layers import RuntimeFlags as RFlags
from repro.models.transformer import LanguageModel as RModel
from repro_torch import configs
from repro_torch.models import LanguageModel, RuntimeFlags, params_from_jax
from repro_torch.models import moe as PM

F32_Y_TOL, F32_AUX_RTOL = 1e-5, 1e-6
BF16_Y_TOL, BF16_AUX_RTOL, BF16_MAX_FLIPS = 2e-2, 1e-6, 0.01


def _x32():
    """JAX's default 32-bit mode for every call into the reference."""
    return jax.enable_x64(False)


def _width(cfg):
    """The width case: Qwen3's d_model and d_ff, top-8 of 16 experts."""
    return dataclasses.replace(
        cfg, name="qwen3-width", num_layers=1, d_model=2048, d_ff=768,
        moe=dataclasses.replace(cfg.moe, num_experts=16, top_k=8))


def _experts(cfg, full):
    """``reduced()`` with the full config's experts (128, top-8 for Qwen3)."""
    return dataclasses.replace(cfg, name="qwen3-experts", moe=full.moe)


CASES = {
    # name: (config name, cut, (B, S), capacity factor)
    "qwen3_reduced": ("qwen3-moe-30b-a3b", "reduced", (2, 32), None),
    "arctic_reduced": ("arctic-480b", "reduced", (2, 32), None),
    "qwen3_width": ("qwen3-moe-30b-a3b", "width", (2, 32), None),
    "qwen3_experts_decode_T8": ("qwen3-moe-30b-a3b", "experts", (8, 1), None),
    "qwen3_reduced_cf0.5": ("qwen3-moe-30b-a3b", "reduced", (2, 32), 0.5),
    "arctic_reduced_cf0.5": ("arctic-480b", "reduced", (2, 32), 0.5),
    "qwen3_width_cf2": ("qwen3-moe-30b-a3b", "width", (2, 32), 2.0),
}


def _cfgs(name, cut):
    r, p = RC.get(name).reduced(), configs.get(name).reduced()
    if cut == "width":
        return _width(r), _width(p)
    if cut == "experts":
        return _experts(r, RC.get(name)), _experts(p, configs.get(name))
    return r, p


def _case(case, dtype):
    name, cut, (B, S), cf = CASES[case]
    rcfg, cfg = _cfgs(name, cut)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    with _x32():
        rp = RM.init_moe(jax.random.PRNGKey(7), rcfg, jnp.float32)
        # compute-dtype weights, the router kept in f32 (the model's cast)
        rp = jax.tree_util.tree_map_with_path(
            lambda path, v: v if path[-1].key == "router" else v.astype(jdt), rp)
    x_np = np.random.default_rng(11).standard_normal((B, S, rcfg.d_model)).astype(np.float32)
    pp = params_from_jax(jax.tree.map(np.array, rp), device="cpu")
    x = torch.from_numpy(x_np).to(tdt)
    return rcfg, cfg, rp, pp, jnp.asarray(x_np, jdt), x, cf


def _reference(rp, rx, rcfg, cf, monkeypatch):
    """The reference's output, aux and the expert ids of its own top_k."""
    seen = []
    top_k = jax.lax.top_k

    def spy(operand, k):
        out = top_k(operand, k)
        seen.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(jax.lax, "top_k", spy)
    with _x32():
        y, aux = RM.moe_apply(rp, rx, rcfg, None, cf)
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    assert len(seen) == 1
    return np.asarray(y, np.float32), float(aux), seen[0].reshape(-1, rcfg.moe.top_k)


def _np_keep(ids: np.ndarray, E: int, C: int) -> np.ndarray:
    flat = ids.reshape(-1)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=E)
    starts = np.cumsum(counts) - counts
    rank = np.empty_like(flat)
    rank[order] = np.arange(flat.size) - starts[flat[order]]
    return rank < C


@pytest.mark.parametrize("case", list(CASES))
def test_f32_moe_matches_reference(case, monkeypatch):
    rcfg, cfg, rp, pp, rx, x, cf = _case(case, "f32")
    y_ref, aux_ref, ids_ref = _reference(rp, rx, rcfg, cf, monkeypatch)
    T = x.shape[0] * x.shape[1]
    r = PM.route(pp, x.reshape(T, -1), cfg, cf)
    with _x32():
        C = RM._capacity(T, rcfg.moe.top_k, rcfg.moe.num_experts,
                         cf or rcfg.moe.capacity_factor)
    assert r.capacity == C
    if case.endswith("decode_T8"):
        assert C == 4
    np.testing.assert_array_equal(r.expert_ids.numpy(), ids_ref)
    keep_ref = _np_keep(ids_ref, rcfg.moe.num_experts, C)
    np.testing.assert_array_equal(r.keep.numpy(), keep_ref)
    if cf == 0.5:
        assert not keep_ref.all()  # tokens drop, and the same ones
    y, aux = PM.moe_apply(pp, x, cfg, cf)
    assert y.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=0,
                               atol=F32_Y_TOL * np.abs(y_ref).max())
    np.testing.assert_allclose(float(aux), aux_ref, rtol=F32_AUX_RTOL)
    assert float(aux) == float(r.aux)


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_moe_matches_reference(case, monkeypatch):
    rcfg, cfg, rp, pp, rx, x, cf = _case(case, "bf16")
    y_ref, aux_ref, ids_ref = _reference(rp, rx, rcfg, cf, monkeypatch)
    T, K = x.shape[0] * x.shape[1], rcfg.moe.top_k
    r = PM.route(pp, x.reshape(T, -1), cfg, cf)
    keep_ref = _np_keep(ids_ref, rcfg.moe.num_experts, r.capacity).reshape(T, K)
    ids, keep = r.expert_ids.numpy(), r.keep.numpy().reshape(T, K)
    pair_differs = (ids != ids_ref) | (keep != keep_ref)
    assert pair_differs.sum() <= BF16_MAX_FLIPS * T * K, f"{pair_differs.sum()} pairs"
    agree = ~pair_differs.any(axis=1)
    y, aux = PM.moe_apply(pp, x, cfg, cf)
    assert y.dtype == torch.bfloat16
    got = y.float().numpy().reshape(T, -1)[agree]
    want = y_ref.reshape(T, -1)[agree]
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_Y_TOL * np.abs(y_ref).max())
    np.testing.assert_allclose(float(aux), aux_ref, rtol=BF16_AUX_RTOL)


def test_top_k_ties_go_to_the_lower_expert():
    """Equal router probabilities pick the lower expert index, as
    ``jax.lax.top_k`` does: a zero router gives every expert 1/E."""
    cfg = configs.get("qwen3-moe-30b-a3b").reduced()
    p = {"router": torch.zeros((cfg.d_model, cfg.moe.num_experts))}
    r = PM.route(p, torch.randn(5, cfg.d_model), cfg)
    assert r.expert_ids.tolist() == [[0, 1]] * 5
    assert torch.equal(r.gates, torch.full((5, 2), 0.5))


def test_init_moe_keeps_the_reference_leaves_and_laws():
    """Keys, shapes and dtypes of the reference's ``init_moe`` (stacked
    over the layer axis as the model stacks them), and its laws: each
    leaf's standard deviation within 5% of 1/sqrt(fan-in)."""
    for name in ("qwen3-moe-30b-a3b", "arctic-480b"):
        rcfg, cfg = _cfgs(name, "reduced")
        rcfg = dataclasses.replace(rcfg, d_model=256, d_ff=384)
        cfg = dataclasses.replace(cfg, d_model=256, d_ff=384)
        with _x32():
            want = jax.eval_shape(lambda k: RM.init_moe(k, rcfg, jnp.bfloat16),
                                  jax.random.PRNGKey(0))
        got = PM.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16, lead=(3,))
        flat_w = {"/".join(str(getattr(k, "key", k)) for k in path): v
                  for path, v in jax.tree_util.tree_flatten_with_path(want)[0]}
        flat_g = {"/".join(str(getattr(k, "key", k)) for k in path): v
                  for path, v in jax.tree_util.tree_flatten_with_path(
                      jax.tree.map(lambda t: t, got))[0]}
        assert sorted(flat_g) == sorted(flat_w)
        for k, w in flat_w.items():
            g = flat_g[k]
            assert tuple(g.shape) == (3,) + tuple(w.shape), k
            assert str(g.dtype).split(".")[-1] == str(w.dtype), k
            fan_in = g.shape[-2]
            std = float(g.float().std())
            assert abs(std * np.sqrt(fan_in) - 1.0) < 0.05, (k, std)
        # every (layer, expert) slice drawn anew
        assert not torch.equal(got["wi_gate"][0, 0], got["wi_gate"][0, 1])
        assert not torch.equal(got["wi_gate"][0, 0], got["wi_gate"][1, 0])


@pytest.mark.parametrize("cf", [0.5, 2.0])
def test_moe_capacity_factor_flag_reaches_the_blocks(cf):
    """``RuntimeFlags.moe_capacity_factor`` sets the blocks' capacity: the
    port's prefill with the flag matches the reference's with the same
    flag (f32 logits within 1e-5, the tolerance of
    ``tests/test_torch_serve.py``), and at 0.5, where tokens drop, it
    differs from the run without the flag."""
    rcfg = RC.get("qwen3-moe-30b-a3b").reduced()
    cfg = configs.get("qwen3-moe-30b-a3b").reduced()
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    rm = RModel(rcfg, flags=RFlags(compute_dtype=jnp.float32, moe_capacity_factor=cf))
    with _x32():
        rp = rm.init(jax.random.PRNGKey(3))
        rl, _ = rm.prefill(rp, jnp.asarray(toks), 32)
    pp = params_from_jax(jax.tree.map(np.array, rp), device="cpu")
    pm = LanguageModel(cfg, RuntimeFlags(compute_dtype=torch.float32, moe_capacity_factor=cf))
    pl, _ = pm.prefill(pp, torch.from_numpy(toks), 32)
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), rtol=0, atol=1e-5)
    base, _ = LanguageModel(cfg, RuntimeFlags(compute_dtype=torch.float32)).prefill(
        pp, torch.from_numpy(toks), 32)
    if cf < 1.0:
        assert not torch.equal(base, pl)
