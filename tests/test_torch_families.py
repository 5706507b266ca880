"""The dense and MoE families of the port (qwen2-0.5b, granite-8b,
qwen2-72b, qwen3-moe-30b-a3b, arctic-480b) against the reference on the
CPU: each config field for field (``param_count`` and
``active_param_count`` too), ``params_from_jax`` keys and dtypes, prefill
logits, four decode steps and the greedy tokens against the reference's
``LanguageModel`` at ``reduced()`` and at two width cuts (qwen2-0.5b at
full width, 2 layers, vocabulary 512: query group 7, tied, QKV bias;
Qwen3 at d_model 2048, head dim 128, query group 8, 16 experts top-8, one
layer, vocabulary 512), and ``loss_fn``'s ce and aux at ``reduced()``.
Weights are the port's ``init`` from a seeded ``torch.Generator``, handed
to the reference as the same numbers (its tree has the port's keys,
checked against the reference's ``init`` structure); tokens come from
numpy.  The reference's ``decode_step`` runs under ``jax.jit``, compiled
once for the four steps.  Attention is ``auto``: the kernels' plain
versions on the CPU.

Routing: the reference's expert ids are read off its own
``jax.lax.top_k`` call in each layer; in f32 the port's own ids must
equal them in every layer of every call.  In bf16 a near tie of two router
probabilities may route a pair elsewhere (the residual stream rounds at
other places in the two models): at most 3% of the (token, choice) pairs
may differ (measured up to 3 of 416 and 3 of 832), and the
logits are compared with the port given the reference's ids, so that they
measure the rest of the arithmetic (unforced, the differing pairs moved
Qwen3's decode logits by up to 0.67 of max|logit|).

Tolerances: those of ``tests/test_torch_serve.py`` and
``tests/test_torch_train.py`` except where a measurement here widened one.
Measured on the CPU, the worst case of the seven models, with these
weights and with the reference's own ``init`` weights (seed 1):
* f32 prefill logits 1e-5 (measured 5.0e-6).
* f32 decode, one step from the reference's cache: 2e-3, widened from
  1e-4 (measured 6.5e-4 on Qwen3 ``reduced()``: 10 of the 256 bf16
  entries of that step's new K/V row round the other way, an f32 value
  within rounding noise of a bf16 boundary).  Decode steps from the
  port's own cache: 5e-3, widened from 1e-3 (measured 1.23e-3, granite-8b
  ``reduced()`` with the reference's weights); greedy tokens equal.
* bf16 logits 3e-2 of max|logit|, widened from 2e-2 (measured 1.97e-2,
  qwen2-72b ``reduced()`` with the reference's weights; 1.6e-2 here).
* ``loss_fn`` ce and aux: f32 rtol 1e-5 (measured 1.6e-7), bf16 2e-2
  (measured 1.8e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models.layers import RuntimeFlags as RFlags
from repro.models.transformer import LanguageModel as RModel
from repro_torch import configs
from repro_torch.checkpoint.store import flatten_with_keys
from repro_torch.models import LanguageModel, RuntimeFlags, params_from_jax
from repro_torch.models import moe as PM

NAMES = ("qwen2-0.5b", "granite-8b", "qwen2-72b", "qwen3-moe-30b-a3b", "arctic-480b")
B, S, MAX_SEQ, N_DECODE = 2, 48, 64, 4
#: the tolerances the module docstring gives, and the share of (token,
#: choice) pairs whose bf16 routing may differ
F32_SAME_CACHE_TOL, F32_OWN_CACHE_TOL, BF16_LOGIT_TOL, BF16_MAX_DIFFERING = 2e-3, 5e-3, 3e-2, 0.03
PARAMS = {
    "qwen2-0.5b": (494_032_768, 494_032_768),
    "granite-8b": (8_254_689_280, 8_254_689_280),
    "qwen2-72b": (72_706_203_648, 72_706_203_648),
    "qwen3-moe-30b-a3b": (30_532_110_336, 3_353_020_416),
    "arctic-480b": (476_850_275_328, 15_584_314_368),
}


def _x32():
    """JAX's default 32-bit mode for every call into the reference."""
    return jax.enable_x64(False)


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _logits(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _cache_to_torch(cache):
    return {"pos": torch.tensor(int(cache["pos"]), dtype=torch.int32),
            "blocks": tuple({k: torch.from_numpy(np.array(v).view(np.int16)).view(torch.bfloat16)
                             for k, v in b.items()} for b in cache["blocks"])}


def _cut(cfg, which: str):
    if which == "reduced":
        return cfg.reduced()
    if which == "qwen2_width":  # full width, 2 layers: group 7, tied, bias
        return dataclasses.replace(cfg, num_layers=2, vocab_size=512)
    # Qwen3 at hd 128, group 8, 16 experts top-8, one layer
    return dataclasses.replace(cfg, num_layers=1, vocab_size=512,
                               moe=dataclasses.replace(cfg.moe, num_experts=16))


class _Routing:
    """The reference's expert ids, call by call, read off its own
    ``jax.lax.top_k`` (an ordered debug callback, which runs inside its
    layer scan), and the port's top-k made to take the ids of the matching
    reference call (``feed``), so that the two models route alike.  Counts
    the (token, choice) pairs where the port's own choice is not among the
    reference's."""

    def __init__(self, monkeypatch):
        self.calls, self.queue = [], []
        self.pairs = self.differing = 0
        top_k, own = jax.lax.top_k, PM._top_k

        def spy(operand, k):
            vals, ids = top_k(operand, k)
            jax.debug.callback(lambda a: self.calls.append(np.asarray(a)), ids, ordered=True)
            return vals, ids

        def forced(probs, k):
            _, mine = own(probs, k)
            want = torch.from_numpy(self.queue.pop(0).reshape(mine.shape).astype(np.int64))
            self.pairs += mine.numel()
            self.differing += int((mine[..., :, None] != want[..., None, :]).all(-1).sum())
            return probs.gather(-1, want), want

        monkeypatch.setattr(jax.lax, "top_k", spy)
        monkeypatch.setattr(PM, "_top_k", forced)

    def take(self) -> list:
        """The reference calls since the last ``take``."""
        jax.effects_barrier()
        out, self.calls = self.calls, []
        return out

    def feed(self, calls: list) -> None:
        assert not self.queue
        self.queue = list(calls)


MODELS = [(n, "reduced") for n in NAMES] + [("qwen2-0.5b", "qwen2_width"),
                                             ("qwen3-moe-30b-a3b", "qwen3_width")]


def _models(name, which, jdt, tdt, seed=1):
    """(reference model, its params, port model, its params, reference
    config): the port's seeded ``init``, the same numbers on both sides."""
    rcfg, cfg = _cut(RC.get(name), which), _cut(configs.get(name), which)
    rm = RModel(rcfg, flags=RFlags(compute_dtype=jdt))
    pm = LanguageModel(cfg, RuntimeFlags(compute_dtype=tdt))
    pp = pm.init(torch.Generator().manual_seed(seed))
    with _x32():
        rp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), pp)
    return rm, rp, pm, pp, rcfg


# --------------------------------------------------------------------------- #
# Configs and parameters
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", NAMES)
def test_config_matches_reference_field_for_field(name):
    ref, port = RC.get(name), configs.get(name)
    assert name in configs.ARCH_NAMES
    for r, p in ((ref, port), (ref.reduced(), port.reduced())):
        assert dataclasses.asdict(p) == dataclasses.asdict(r)
        assert (p.resolved_head_dim, p.n_repeats, p.param_count(), p.active_param_count()) == \
               (r.resolved_head_dim, r.n_repeats, r.param_count(), r.active_param_count())
    assert (port.param_count(), port.active_param_count()) == PARAMS[name]


@pytest.mark.parametrize("name", NAMES)
def test_params_from_jax_keep_the_reference_keys_and_dtypes(name):
    """At ``reduced()`` with the full config's ``param_dtype`` (bf16 for
    qwen2-72b and arctic-480b: the router stays f32): the reference
    ``init``'s tree (its structure, shapes and dtypes from
    ``jax.eval_shape``) filled with numpy draws."""
    dt = RC.get(name).param_dtype
    rcfg = dataclasses.replace(RC.get(name).reduced(), param_dtype=dt)
    cfg = dataclasses.replace(configs.get(name).reduced(), param_dtype=dt)
    rng = np.random.default_rng(0)
    with _x32():
        shapes = jax.eval_shape(RModel(rcfg).init, jax.random.PRNGKey(0))
        rp = jax.tree.map(lambda s: np.asarray(
            jnp.asarray(rng.standard_normal(s.shape), s.dtype)), shapes)
        want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
                for path, leaf in jax.tree_util.tree_flatten_with_path(rp)[0]}
    conv = flatten_with_keys(params_from_jax(_np_tree(rp), device="cpu"))
    assert list(conv) == list(want)
    for k, v in conv.items():
        w = np.asarray(want[k])
        assert str(v.dtype).split(".")[-1] == str(w.dtype), k
        assert np.array_equal(v.float().numpy(), w.astype(np.float32)), k
    if cfg.moe is not None:
        assert conv["blocks/0/mlp/router"].dtype == torch.float32
        assert ("blocks/0/mlp/dense/wo" in conv) == cfg.moe.dense_residual
    mine = flatten_with_keys(LanguageModel(cfg).init(torch.Generator().manual_seed(0)))
    assert list(mine) == list(want)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in mine.items()} == \
           {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}


# --------------------------------------------------------------------------- #
# Prefill and decode against the reference model
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name,which", MODELS)
def test_f32_prefill_and_decode_match_reference(name, which, monkeypatch):
    """f32: the port's own routing equals the reference's in every layer
    of every call (no pair differs)."""
    routing = _Routing(monkeypatch)
    rm, rp, pm, pp, rcfg = _models(name, which, jnp.float32, torch.float32)
    V = rcfg.vocab_size
    toks = np.random.default_rng(2).integers(0, V, (B, S)).astype(np.int32)
    with _x32():
        rl, rc = rm.prefill(rp, jnp.asarray(toks), MAX_SEQ)
    routing.feed(routing.take())
    pl, pc = pm.prefill(pp, torch.from_numpy(toks), MAX_SEQ)
    assert pl.shape == (B, 1, V) and pl.dtype == torch.float32
    np.testing.assert_allclose(_logits(pl), _logits(rl), atol=1e-5, rtol=0)
    tok = jnp.argmax(rl[:, -1], -1).astype(jnp.int32)[:, None]
    decode = jax.jit(rm.decode_step)
    for _ in range(N_DECODE):
        synced = _cache_to_torch(rc)  # the reference's cache: one step's math alone
        with _x32():
            rl, rc = decode(rp, rc, tok)
        calls = routing.take()
        routing.feed(calls)
        sl, _ = pm.decode_step(pp, synced, torch.from_numpy(np.array(tok)))
        routing.feed(calls)
        pl, pc = pm.decode_step(pp, pc, torch.from_numpy(np.array(tok)))
        np.testing.assert_allclose(_logits(sl), _logits(rl), atol=F32_SAME_CACHE_TOL, rtol=0)
        np.testing.assert_allclose(_logits(pl), _logits(rl), atol=F32_OWN_CACHE_TOL, rtol=0)
        assert np.array_equal(_logits(pl).argmax(-1), _logits(rl).argmax(-1))
        tok = jnp.argmax(rl[:, -1], -1).astype(jnp.int32)[:, None]
    assert int(pc["pos"]) == S + N_DECODE
    if rcfg.moe is not None:  # every layer routed: the prefill, two decodes a step
        assert routing.pairs == rcfg.num_layers * B * rcfg.moe.top_k * (S + 2 * N_DECODE)
    assert routing.differing == 0


@pytest.mark.parametrize("name,which", MODELS)
def test_bf16_prefill_and_decode_match_reference(name, which, monkeypatch):
    """bf16: the routing may differ at near ties; the differing pairs are
    bounded, and the logits are compared with the port routed as the
    reference (its top-k given the reference's ids)."""
    routing = _Routing(monkeypatch)
    rm, rp, pm, pp, rcfg = _models(name, which, jnp.bfloat16, torch.bfloat16)
    toks = np.random.default_rng(3).integers(0, rcfg.vocab_size, (B, S)).astype(np.int32)
    with _x32():
        rl, rc = rm.prefill(rp, jnp.asarray(toks), MAX_SEQ)
    routing.feed(routing.take())
    pl, pc = pm.prefill(pp, torch.from_numpy(toks), MAX_SEQ)
    assert pl.dtype == torch.bfloat16
    np.testing.assert_allclose(_logits(pl), _logits(rl), rtol=0,
                               atol=BF16_LOGIT_TOL * float(np.abs(_logits(rl)).max()))
    tok = jnp.argmax(rl[:, -1], -1).astype(jnp.int32)[:, None]
    decode = jax.jit(rm.decode_step)
    for _ in range(N_DECODE):
        with _x32():
            rl, rc = decode(rp, rc, tok)
        routing.feed(routing.take())
        pl, pc = pm.decode_step(pp, pc, torch.from_numpy(np.array(tok)))
        np.testing.assert_allclose(_logits(pl), _logits(rl), rtol=0,
                                   atol=BF16_LOGIT_TOL * float(np.abs(_logits(rl)).max()))
        tok = jnp.argmax(rl[:, -1], -1).astype(jnp.int32)[:, None]
    assert routing.differing <= BF16_MAX_DIFFERING * routing.pairs


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("name", NAMES)
def test_loss_fn_ce_and_aux_match_reference(name, compute):
    jdt, tdt = (jnp.float32, torch.float32) if compute == "f32" else (jnp.bfloat16, torch.bfloat16)
    rm, rp, pm, pp, rcfg = _models(name, "reduced", jdt, tdt, seed=4)
    toks = np.random.default_rng(4).integers(0, rcfg.vocab_size, (B, 32)).astype(np.int32)
    with _x32():
        want, wm = rm.loss_fn(rp, {"tokens": jnp.asarray(toks)})
    got, gm = pm.loss_fn(pp, {"tokens": torch.from_numpy(toks)})
    rtol = 1e-5 if compute == "f32" else 2e-2
    np.testing.assert_allclose(float(gm["ce"]), float(wm["ce"]), rtol=rtol)
    np.testing.assert_allclose(float(gm["aux"]), float(wm["aux"]), rtol=rtol)
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)
    if rcfg.moe is None:
        assert float(gm["aux"]) == 0.0
    else:  # one load-balance loss a layer, each near 1 for a balanced router
        assert 0.5 * rcfg.num_layers < float(gm["aux"]) < 2.0 * rcfg.num_layers


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "arctic-480b"])
def test_moe_serve_with_faults_gives_the_fault_free_tokens(name):
    """The MoE path has no atomics and no data-dependent order, so a
    faulted ``serve()`` (restores and re-decoded tokens) gives the
    fault-free run's tokens."""
    from repro_torch.launch import serve as SV

    cfg = configs.get(name).reduced()
    kw = dict(requests=3, prompt_len=12, gen=24, snapshot_every=4, seed=5, device="cpu")
    clean = SV.serve(cfg, **kw)
    t0, dt = clean["prefill_s"], clean["decode_s"]
    faulted = SV.serve(cfg, fault_times=[0.0] + [t0 + f * dt for f in (0.3, 0.5, 0.7)], **kw)
    assert faulted["faults"] >= 1
    assert torch.equal(faulted["tokens"], clean["tokens"])
