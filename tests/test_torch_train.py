"""The port's training step (``repro_torch.models`` ``loss_fn``,
``repro_torch.optim``, ``repro_torch.launch.steps.build_train_step``)
against the reference's on the CPU, on SmolLM-135M's ``reduced()``
config.  Weights are the reference's ``init`` converted by
``params_from_jax``; tokens and gradients come from numpy.

Tolerances (measured on the CPU before they were set):
* ``cross_entropy_loss``: rtol 1e-6 (measured 0 to 2e-7).
* ``loss_fn``, f32 compute: rtol 1e-5 (measured up to 4e-7); bf16
  compute: rtol 2e-2 (measured up to 1e-3).
* every gradient leaf: within 1e-4 of the leaf's max |g| (measured up to
  3e-6; XLA's and torch's f32 products sum in other orders).
* ``adamw_update`` on identical gradients, four steps so that the moments
  matter (step 1's update is sign(g) whatever the moments): params and f32
  moments rtol 1e-6 with an atol of 1e-6 of the leaf's max |x| (an entry
  where ``b1 m + (1 - b1) g`` cancels measured 1.9e-6 rel, 9e-11 abs: XLA
  contracts the sum into an FMA), int8 moments within one level, their
  scales as the f32 moments.
* three ``build_train_step`` steps: losses rtol 1e-4 (measured up to
  3e-7); ``micro_batches=2`` against 1 on the same batch within 1e-5.
* remat ``"full"`` / ``"dots"`` against ``"none"`` (smollm, rwkv6 and
  jamba ``reduced()``): the loss and every gradient leaf bit-equal, as
  recomputation repeats the forward's operations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.launch.steps import build_model as r_build_model
from repro.launch.steps import build_train_step as r_build_train_step
from repro.models.layers import RuntimeFlags as RFlags
from repro.models.layers import cross_entropy_loss as r_cross_entropy
from repro.optim import adamw as RA
from repro_torch import configs
from repro_torch.checkpoint.store import flatten_with_keys, map_with_keys
from repro_torch.kernels import ops
from repro_torch.launch.steps import build_model, build_train_step
from repro_torch.models import LanguageModel, RuntimeFlags, params_from_jax
from repro_torch.models.layers import cross_entropy_loss
from repro_torch.optim import adamw as PA

B, S = 4, 32


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _ref_model(flags):
    return r_build_model(RC.get("smollm-135m").reduced(), mesh=None, flags=flags)[0]


def _pair(compute: str, dense_attn_max: int, kv_chunk: int = 1024, attn_impl="auto"):
    """(reference model, its params, port model, the same params)."""
    rflags = RFlags(attn_impl=attn_impl, dense_attn_max=dense_attn_max, kv_chunk=kv_chunk,
                    compute_dtype=jnp.float32 if compute == "f32" else jnp.bfloat16)
    pflags = RuntimeFlags(attn_impl=attn_impl, dense_attn_max=dense_attn_max, kv_chunk=kv_chunk,
                          compute_dtype=torch.float32 if compute == "f32" else torch.bfloat16)
    rm = _ref_model(rflags)
    rp = rm.init(jax.random.PRNGKey(0))
    pm = LanguageModel(configs.get("smollm-135m").reduced(), pflags)
    return rm, rp, pm, params_from_jax(_np_tree(rp), device="cpu")


def _tokens(seed=0, b=B, s=S):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


def _grads(model, params, batch):
    live = map_with_keys(lambda _, p: p.detach().requires_grad_(True), params)
    loss, aux = model.loss_fn(live, batch)
    flat = flatten_with_keys(live)
    return loss, aux, dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))


# --------------------------------------------------------------------------- #
# Loss
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    tgt = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = float(r_cross_entropy(jnp.asarray(logits), jnp.asarray(tgt),
                                 None if mask is None else jnp.asarray(mask)))
    got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(tgt),
                             None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_cross_entropy_gradient_skips_the_max():
    """The row max is held out of the gradient (the reference's
    ``stop_gradient``), so d loss / d logits is softmax - onehot."""
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal((2, 3, 11)).astype(np.float32))
    logits.requires_grad_(True)
    tgt = torch.from_numpy(rng.integers(0, 11, (2, 3)))
    cross_entropy_loss(logits, tgt).backward()
    want = (torch.softmax(logits.detach(), -1) - torch.nn.functional.one_hot(tgt, 11)) / 6
    torch.testing.assert_close(logits.grad, want, rtol=1e-5, atol=1e-7)


CASES = [  # (compute, dense_attn_max, kv_chunk, what auto resolves to)
    ("f32", 64, 1024, "dense"),
    ("f32", S, 1024, "dense"),  # at the bound: dense
    ("f32", S - 1, 8, "chunked"),  # past it: chunked, 4 KV chunks
    ("bf16", 64, 1024, "dense"),
    ("bf16", 16, 16, "chunked"),
]


@pytest.mark.parametrize("compute,dmax,kv_chunk,impl", CASES)
def test_loss_fn_matches_reference(compute, dmax, kv_chunk, impl, monkeypatch):
    rm, rp, pm, pp = _pair(compute, dmax, kv_chunk)
    from repro_torch.models import layers as L

    seen = []
    for name in ("_dense_attn", "_chunked_attn"):
        real = getattr(L, name)
        monkeypatch.setattr(
            L, name, lambda *a, _r=real, _n=name, **k: seen.append(_n) or _r(*a, **k))
    toks = _tokens()
    want, wm = rm.loss_fn(rp, {"tokens": jnp.asarray(toks)})
    got, gm = pm.loss_fn(pp, {"tokens": torch.from_numpy(toks)})
    assert set(seen) == {"_" + impl + "_attn"}
    rtol = 1e-5 if compute == "f32" else 2e-2
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)
    np.testing.assert_allclose(float(gm["ce"]), float(wm["ce"]), rtol=rtol)
    assert float(gm["aux"]) == float(wm["aux"]) == 0.0
    assert got.dtype == torch.float32


@pytest.mark.parametrize("dmax,kv_chunk", [(64, 1024), (S - 1, 8)])
def test_gradients_match_jax_grad(dmax, kv_chunk):
    rm, rp, pm, pp = _pair("f32", dmax, kv_chunk)
    toks = _tokens(3)
    want = jax.grad(lambda p: rm.loss_fn(p, {"tokens": jnp.asarray(toks)})[0])(rp)
    want = {k: np.asarray(v) for k, v in flatten_with_keys(_np_tree(want)).items()}
    _, _, got = _grads(pm, pp, {"tokens": torch.from_numpy(toks)})
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32, k
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), k
    # the stacked leaves and the tied embedding all get a gradient
    assert all(np.abs(w).max() > 0 for w in want.values())


def test_bf16_gradients_reach_the_f32_masters():
    _, _, pm, pp = _pair("bf16", 64)
    _, _, got = _grads(pm, pp, {"tokens": torch.from_numpy(_tokens())})
    for k, g in got.items():
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()), k
        assert float(g.abs().max()) > 0, k


def test_remat_policies_are_refused_with_the_roadmap_item():
    """The reference's three policies build; "dots" saves the outputs of
    the matrix products without a batch dimension (a spy on the policy sees
    ``aten.mm`` saved and ``aten.bmm`` recomputed), and only a name the
    reference does not know is refused."""
    from torch.utils.checkpoint import CheckpointPolicy
    from repro_torch.models import transformer as T

    cfg = configs.get("smollm-135m").reduced()
    with pytest.raises(ValueError, match="remat_policy"):
        LanguageModel(cfg, RuntimeFlags(remat_policy="offload"))
    seen = {}

    def spy(ctx, op, *args, **kwargs):
        got = T._dots_policy(ctx, op, *args, **kwargs)
        seen.setdefault(op, got)
        return got

    import functools
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    kw = {"context_fn": functools.partial(create_selective_checkpoint_contexts, spy)}
    real = T._REMAT["dots"]
    T._REMAT["dots"] = kw
    try:
        pm = LanguageModel(cfg, RuntimeFlags(remat_policy="dots", compute_dtype=torch.float32,
                                             dense_attn_max=64))
        _grads(pm, pm.init(torch.Generator().manual_seed(0)),
               {"tokens": torch.from_numpy(_tokens())})
    finally:
        T._REMAT["dots"] = real
    assert seen[torch.ops.aten.mm.default] == CheckpointPolicy.MUST_SAVE
    assert seen[torch.ops.aten.bmm.default] == CheckpointPolicy.PREFER_RECOMPUTE


@pytest.mark.parametrize("name", ["smollm-135m", "rwkv6-7b", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_is_bit_equal_to_none(name, policy):
    """Loss and every gradient leaf of ``reduced()`` under ``"full"`` and
    ``"dots"`` remat bit-equal to ``"none"`` (f32 compute; RWKV6's WKV and
    Jamba's scan recomputed through their autograd Functions)."""
    cfg = configs.get(name).reduced()
    toks = {"tokens": torch.from_numpy(_tokens(5, b=2, s=16))}
    out = {}
    for pol in ("none", policy):
        pm = LanguageModel(cfg, RuntimeFlags(remat_policy=pol, compute_dtype=torch.float32))
        out[pol] = _grads(pm, pm.init(torch.Generator().manual_seed(0)), toks)
    (l0, a0, g0), (l1, a1, g1) = out["none"], out[policy]
    assert torch.equal(l0, l1) and torch.equal(a0["aux"], a1["aux"])
    assert list(g0) == list(g1)
    for k, g in g0.items():
        assert torch.equal(g, g1[k]), k


def test_prefill_auto_still_takes_the_kernel():
    """Outside training ``auto`` is the kernel wrapper (its plain version
    on the CPU), whatever ``dense_attn_max`` says."""
    pm = LanguageModel(configs.get("smollm-135m").reduced(),
                       RuntimeFlags(compute_dtype=torch.float32, dense_attn_max=4))
    p = pm.init(torch.Generator().manual_seed(0))
    calls = []
    real = ops.flash_attention
    try:
        ops.flash_attention = lambda *a, **k: calls.append(1) or real(*a, **k)
        pm.prefill(p, torch.from_numpy(_tokens()), S + 4)
        assert len(calls) == 2
        calls.clear()
        pm.loss_fn(p, {"tokens": torch.from_numpy(_tokens())})
        assert calls == []
    finally:
        ops.flash_attention = real


# --------------------------------------------------------------------------- #
# Backward guards
# --------------------------------------------------------------------------- #
def test_backward_through_flash_attention_raises():
    _, _, pm, pp = _pair("f32", 64, attn_impl="pallas")
    live = map_with_keys(lambda _, p: p.detach().requires_grad_(True), pp)
    loss, _ = pm.loss_fn(live, {"tokens": torch.from_numpy(_tokens())})
    with pytest.raises(NotImplementedError, match="flash_attention_bhsd has no backward"):
        loss.backward()


def test_guarded_forwards_are_the_wrappers():
    """With an operand that requires a gradient each wrapper's forward is
    the same call (same values); the attention wrappers' backward raises,
    the WKV recurrence's is the plain reverse recurrence."""
    rng = np.random.default_rng(4)

    def t(*shape, grad=True):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.requires_grad_(grad)

    q, k, v = t(2, 5, 4, 16), t(2, 5, 2, 16, grad=False), t(2, 5, 2, 16, grad=False)
    out = ops.flash_attention(q, k, v)
    torch.testing.assert_close(out.detach(), ops.flash_attention(q.detach(), k, v), rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="flash_attention_bhsd"):
        out.sum().backward()

    qd, kc, vc = t(2, 1, 4, 16), t(2, 9, 2, 16, grad=False), t(2, 9, 2, 16, grad=False)
    pos = torch.tensor(6, dtype=torch.int32)
    out = ops.decode_attention(qd, kc, vc, pos)
    assert out.shape == (2, 1, 4, 16)
    torch.testing.assert_close(out.detach(), ops.decode_attention(qd.detach(), kc, vc, pos),
                               rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="decode_attention_bhd"):
        out.sum().backward()

    # the WKV recurrence has a backward now (the reference differentiates
    # its lax.scan): the gradient is the plain reverse recurrence's
    r, kk, vv = t(1, 6, 2, 16), t(1, 6, 2, 16, grad=False), t(1, 6, 2, 16, grad=False)
    w = torch.rand((1, 6, 2, 16), generator=torch.Generator().manual_seed(0))
    u = t(2, 16, grad=False)
    state = torch.zeros((1, 2, 16, 16))
    y, s = ops.wkv6(r, kk, vv, w, u, None, state_out=state)
    y0, s0 = ops.wkv6(r.detach(), kk, vv, w, u, None)
    assert torch.equal(state, s0) and torch.equal(s.detach(), s0) and torch.equal(y.detach(), y0)
    y.sum().backward()
    from repro_torch.kernels.rwkv6 import wkv_bwd_ref
    want = wkv_bwd_ref(r.detach(), kk, vv, w, u[None], None, torch.ones_like(y0))[0]
    assert torch.equal(r.grad, want)
    # without a gradient the wrappers are called directly
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None


# --------------------------------------------------------------------------- #
# The optimizer
# --------------------------------------------------------------------------- #
def _np_params(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((32, 300)).astype(np.float32),
            "b": (rng.standard_normal(16) * 0.1).astype(np.float32),
            "s": np.full((), 0.5, np.float32),
            "stack": rng.standard_normal((3, 5, 260)).astype(np.float32)}


def _np_grads(seed, like):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(rng.standard_normal(np.shape(v)) * 0.3, np.float32)
            for k, v in like.items()}


@pytest.mark.parametrize("quantize", [False, True])
def test_adamw_matches_reference_over_steps(quantize):
    p_np = _np_params(0)
    rp = jax.tree.map(jnp.asarray, p_np)
    pp = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    rs, ps = RA.adamw_init(rp, quantize=quantize), PA.adamw_init(pp, quantize=quantize)
    for step in range(4):
        g = _np_grads(10 + step, p_np)
        if step == 2:
            g["w"][:3] *= 50.0  # past the clip norm
        lr = 1e-2 * (step + 1)
        rp, rs, rm = RA.adamw_update(jax.tree.map(jnp.asarray, g), rs, rp, jnp.float32(lr))
        pp, ps, pm = PA.adamw_update({k: torch.from_numpy(v) for k, v in g.items()}, ps, pp,
                                     torch.tensor(lr, dtype=torch.float32))
        np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]), rtol=1e-6)
    assert int(ps.step) == int(rs.step) == 4 and ps.step.dtype == torch.int32
    for k in p_np:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(rp[k]), rtol=1e-6, atol=1e-7)
    want = {k: np.asarray(v) for k, v in flatten_with_keys(_np_tree(rs.moments)).items()}
    got = flatten_with_keys(ps.moments)
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if g.dtype == np.int8:
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1, k
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * np.abs(w).max(), err_msg=k)


def test_adamw_sliced_loop_equals_whole_leaf(monkeypatch):
    """The leading-dim loop for giant stacked leaves gives the whole-leaf
    update bit for bit (the threshold lowered to reach it), in chunks of
    one slice and of several."""
    p_np = _np_params(1)
    g = {k: torch.from_numpy(v) for k, v in _np_grads(2, p_np).items()}
    for quantize in (False, True):
        pp = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
        st = PA.adamw_init(pp, quantize=quantize)
        a = PA.adamw_update(g, st, pp, 1e-2)
        for chunk in (1, 600, 1 << 26):  # elements a chunk: 1 and 2 slices, the whole leaf
            monkeypatch.setattr(PA, "_SLICED_MIN", 8)
            monkeypatch.setattr(PA, "_SLICE_ELEMS", chunk)
            b = PA.adamw_update(g, st, pp, 1e-2)
            monkeypatch.setattr(PA, "_SLICED_MIN", 1 << 29)
            for x, y in zip(flatten_with_keys(a[:2]).values(),
                            flatten_with_keys(b[:2]).values()):
                assert torch.equal(x, y)


def test_adamw_update_leaves_its_inputs_untouched():
    p_np = _np_params(2)
    pp = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    g = {k: torch.from_numpy(v) for k, v in _np_grads(3, p_np).items()}
    for quantize in (False, True):
        st = PA.adamw_init(pp, quantize=quantize)
        st = PA.adamw_update(g, st, pp, 1e-2)[1]  # moments not zero
        before = [x.clone() for x in flatten_with_keys((pp, g, st)).values()]
        new_p, new_s, _ = PA.adamw_update(g, st, pp, 1e-2)
        after = list(flatten_with_keys((pp, g, st)).values())
        assert all(torch.equal(x, y) for x, y in zip(before, after))
        ins = {x.data_ptr() for x in after}
        assert not ins & {x.data_ptr() for x in flatten_with_keys((new_p, new_s)).values()}


def test_cosine_schedule_and_global_norm():
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        for warmup, total in ((10, 100), (100, 60), (0, 1)):
            want = float(RA.cosine_schedule(step, 3e-4, warmup=warmup, total=total))
            got = PA.cosine_schedule(torch.tensor(step, dtype=torch.int32), 3e-4,
                                     warmup=warmup, total=total)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-12)
    assert float(PA.cosine_schedule(0, 1.0, warmup=10, total=100)) == 0.0
    assert float(PA.cosine_schedule(100, 1.0, warmup=10, total=100)) == pytest.approx(0.1)
    p_np = _np_params(5)
    np.testing.assert_allclose(
        float(PA.global_norm({k: torch.from_numpy(v) for k, v in p_np.items()})),
        float(RA.global_norm(jax.tree.map(jnp.asarray, p_np))), rtol=1e-6)
    assert float(PA.global_norm({"a": torch.ones(3) * 2.0})) == pytest.approx(np.sqrt(12.0))


def test_adamw_state_is_a_namedtuple_with_the_reference_fields():
    assert PA.AdamWState._fields == RA.AdamWState._fields == ("step", "moments")


# --------------------------------------------------------------------------- #
# The train step
# --------------------------------------------------------------------------- #
def test_three_train_steps_match_reference():
    rflags = RFlags(dense_attn_max=512, compute_dtype=jnp.float32)
    rm = _ref_model(rflags)
    rp = rm.init(jax.random.PRNGKey(0))
    ro = RA.adamw_init(rp)
    rstep = jax.jit(r_build_train_step(rm, lr=1e-3, total_steps=20))
    pm = build_model(configs.get("smollm-135m").reduced(),
                     RuntimeFlags(dense_attn_max=512, compute_dtype=torch.float32))
    pp = params_from_jax(_np_tree(rp), device="cpu")
    po = PA.adamw_init(pp)
    pstep = build_train_step(pm, lr=1e-3, total_steps=20)
    for k in range(3):
        toks = _tokens(20 + k)
        rp, ro, rmet = rstep(rp, ro, {"tokens": jnp.asarray(toks)})
        pp, po, pmet = pstep(pp, po, {"tokens": torch.from_numpy(toks)})
        assert set(pmet) == set(rmet) == {"loss", "ce", "aux", "grad_norm"}
        assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in pmet.values())
        for name in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(pmet[name]), float(rmet[name]), rtol=1e-4)
    for key, w in flatten_with_keys(_np_tree(rp)).items():
        np.testing.assert_allclose(flatten_with_keys(pp)[key].numpy(), w, rtol=1e-3, atol=1e-6)


def test_micro_batches_match_the_whole_batch_and_the_reference():
    rflags = RFlags(dense_attn_max=512, compute_dtype=jnp.float32)
    rm = _ref_model(rflags)
    rp = rm.init(jax.random.PRNGKey(1))
    pm = build_model(configs.get("smollm-135m").reduced(),
                     RuntimeFlags(dense_attn_max=512, compute_dtype=torch.float32))
    pp = params_from_jax(_np_tree(rp), device="cpu")
    toks = _tokens(7)
    out = {}
    for mb in (1, 2):
        out[mb] = build_train_step(pm, lr=1e-3, total_steps=20, micro_batches=mb)(
            pp, PA.adamw_init(pp), {"tokens": torch.from_numpy(toks)})
    r2 = jax.jit(r_build_train_step(rm, lr=1e-3, total_steps=20, micro_batches=2))(
        rp, RA.adamw_init(rp), {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(float(out[2][2]["loss"]), float(r2[2]["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(out[2][2]["ce"]), float(r2[2]["ce"]), rtol=1e-5)
    # the last micro-batch's ce, the mean loss
    np.testing.assert_allclose(float(out[2][2]["loss"]), float(out[1][2]["loss"]), rtol=1e-5)
    for key, a in flatten_with_keys(out[2][0]).items():
        torch.testing.assert_close(a, flatten_with_keys(out[1][0])[key], rtol=1e-5, atol=1e-6)


def test_rwkv_loss_forward_runs_and_backward_raises():
    """RWKV6 trains: its forward runs (the WKV plain version on the CPU) and
    the backward reaches every leaf through the WKV Function
    (``test_torch_rwkv6_bwd.py`` holds the gradients to ``jax.grad``)."""
    cfg = configs.get("rwkv6-7b").reduced()
    pm = LanguageModel(cfg, RuntimeFlags(compute_dtype=torch.float32))
    p = pm.init(torch.Generator().manual_seed(0))
    live = map_with_keys(lambda _, x: x.detach().requires_grad_(True), p)
    loss, _ = pm.loss_fn(live, {"tokens": torch.from_numpy(_tokens(b=2, s=8))})
    assert bool(torch.isfinite(loss))
    loss.backward()
    for k, x in flatten_with_keys(live).items():
        assert x.grad is not None and bool(torch.isfinite(x.grad).all()), k
