"""The families of the port (the dense qwen2-0.5b, granite-8b, qwen2-72b;
the MoE qwen3-moe-30b-a3b, arctic-480b; the Mamba hybrid
jamba-1.5-large-398b; the frontend families llava-next-mistral-7b and
musicgen-large) against the reference on the CPU: each config field for
field (``param_count`` and ``active_param_count`` too), ``params_from_jax``
keys and dtypes, prefill logits, four decode steps and the greedy tokens
against the reference's ``LanguageModel`` at ``reduced()`` and at width
cuts (qwen2-0.5b at full width, 2 layers, vocabulary 512: query group 7,
tied, QKV bias; Qwen3 at d_model 2048, head dim 128, query group 8, 16
experts top-8, one layer, vocabulary 512; Jamba at d_model 1024, head dim
128, query group 8, d_state 16, 16 experts top-2, its 8 pattern layers,
vocabulary 512; llava-next at d_model 1024, head dim 128, group 4, its
576-row prefix, 2 layers, vocabulary 512; musicgen at d_model 512, head
dim 64, group 1, its 64-row prefix, 2 layers), ``loss_fn``'s ce and aux
at ``reduced()`` (the frontend families with their prefix), faulted
serving, and the frontend batches of ``serve()`` and ``launch.train``.
The frontend embeddings come from numpy.
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
* Jamba (the Mamba hybrid), widened by measurement: f32 prefill logits
  3e-5 at the width cut (measured 1.12e-5 against max|logit| 3.2: eight
  layers of d_inner 2048); bf16 logits 8e-2 of max|logit| (measured up to
  4.1e-2 over four decode steps at the width cut, 4.4e-2 for a step from
  the reference's cache; 2.7e-2 after the prefill).  That is bf16 noise compounded over seven Mamba
  layers: one Mamba mixer in bf16 sits 0.7% from the reference's
  (``tests/test_torch_mamba.py``), and the reference's own bf16 logits sit
  up to 7.1e-2 from its f32 logits at the steps where the two route alike.
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

NAMES = ("qwen2-0.5b", "granite-8b", "qwen2-72b", "qwen3-moe-30b-a3b", "arctic-480b",
         "jamba-1.5-large-398b", "llava-next-mistral-7b", "musicgen-large")
FRONTENDS = ("llava-next-mistral-7b", "musicgen-large")
B, S, MAX_SEQ, N_DECODE = 2, 48, 64, 4
#: the tolerances the module docstring gives, and the share of (token,
#: choice) pairs whose bf16 routing may differ
F32_SAME_CACHE_TOL, F32_OWN_CACHE_TOL, BF16_LOGIT_TOL, BF16_MAX_DIFFERING = 2e-3, 5e-3, 3e-2, 0.03
#: the f32 prefill logits' tolerance and the bf16 logits', widened for the
#: Mamba hybrid by measurement (module docstring)
F32_PREFILL_TOL = {"jamba_width": 3e-5}
BF16_TOL_OF = {"jamba-1.5-large-398b": 8e-2}
PARAMS = {
    "qwen2-0.5b": (494_032_768, 494_032_768),
    "granite-8b": (8_254_689_280, 8_254_689_280),
    "qwen2-72b": (72_706_203_648, 72_706_203_648),
    "qwen3-moe-30b-a3b": (30_532_110_336, 3_353_020_416),
    "arctic-480b": (476_850_275_328, 15_584_314_368),
    "jamba-1.5-large-398b": (398_553_047_040, 94_147_239_936),
    "llava-next-mistral-7b": (7_241_732_096, 7_241_732_096),
    "musicgen-large": (3_229_812_736, 3_229_812_736),
}


def _x32():
    """JAX's default 32-bit mode for every call into the reference."""
    return jax.enable_x64(False)


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _logits(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _leaf_to_torch(v) -> torch.Tensor:
    a = np.array(v)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _cache_to_torch(cache):
    """The reference's cache (bf16 K/V and conv windows, f32 SSM states)."""
    return {"pos": torch.tensor(int(cache["pos"]), dtype=torch.int32),
            "blocks": tuple({k: _leaf_to_torch(v) for k, v in b.items()}
                            for b in cache["blocks"])}


def _cut(cfg, which: str):
    if which == "reduced":
        return cfg.reduced()
    if which == "qwen2_width":  # full width, 2 layers: group 7, tied, bias
        return dataclasses.replace(cfg, num_layers=2, vocab_size=512)
    if which == "jamba_width":  # hd 128, group 8, d_state 16, 16 experts top-2
        return dataclasses.replace(cfg, num_layers=8, d_model=1024, num_heads=8, num_kv_heads=1,
                                   d_ff=512, vocab_size=512, param_dtype="float32")
    if which == "llava_width":  # hd 128, group 4, the 576-row prefix
        return dataclasses.replace(cfg, num_layers=2, d_model=1024, num_heads=8, num_kv_heads=2,
                                   d_ff=1024, vocab_size=512)
    if which == "musicgen_width":  # hd 64, group 1, the 64-row prefix
        return dataclasses.replace(cfg, num_layers=2, d_model=512, num_heads=8, num_kv_heads=8,
                                   d_ff=1024)
    # Qwen3 at hd 128, group 8, 16 experts top-8, one layer
    return dataclasses.replace(cfg, num_layers=1, vocab_size=512,
                               moe=dataclasses.replace(cfg.moe, num_experts=16))


def _moe_layers(cfg) -> int:
    return cfg.n_repeats * sum(s.mlp == "moe" for s in cfg.pattern)


def _frontend(cfg, seed: int):
    """(reference, port) frontend embeddings ``(B, prefix, D)`` f32 from
    numpy, or (None, None)."""
    if not cfg.frontend:
        return None, None
    fe = (np.random.default_rng(seed).standard_normal((B, cfg.frontend_prefix, cfg.d_model))
          * 0.02).astype(np.float32)
    with _x32():
        return jnp.asarray(fe), torch.from_numpy(fe)


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
                                             ("qwen3-moe-30b-a3b", "qwen3_width"),
                                             ("jamba-1.5-large-398b", "jamba_width"),
                                             ("llava-next-mistral-7b", "llava_width"),
                                             ("musicgen-large", "musicgen_width")]


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
        pi = next(i for i, s in enumerate(cfg.pattern) if s.mlp == "moe")
        assert conv[f"blocks/{pi}/mlp/router"].dtype == torch.float32
        assert (f"blocks/{pi}/mlp/dense/wo" in conv) == cfg.moe.dense_residual
    for pi, spec in enumerate(cfg.pattern):
        if spec.mixer == "mamba":  # A_log, D_skip f32; dt_b and the rest the param dtype
            pd = torch.bfloat16 if dt == "bfloat16" else torch.float32
            for leaf in ("in_proj", "conv_w", "conv_b", "x_proj", "dt_w", "dt_b", "A_log",
                         "D_skip", "out_proj"):
                want_dt = torch.float32 if leaf in ("A_log", "D_skip") else pd
                assert conv[f"blocks/{pi}/mixer/{leaf}"].dtype == want_dt, (pi, leaf)
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
    rf, pf = _frontend(rcfg, 6)
    max_seq = MAX_SEQ + rcfg.frontend_prefix
    with _x32():
        rl, rc = rm.prefill(rp, jnp.asarray(toks), max_seq, rf)
    routing.feed(routing.take())
    pl, pc = pm.prefill(pp, torch.from_numpy(toks), max_seq, pf)
    assert pl.shape == (B, 1, V) and pl.dtype == torch.float32
    np.testing.assert_allclose(_logits(pl), _logits(rl), atol=F32_PREFILL_TOL.get(which, 1e-5),
                               rtol=0)
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
    assert int(pc["pos"]) == rcfg.frontend_prefix + S + N_DECODE
    if rcfg.moe is not None:  # every MoE layer routed: the prefill, two decodes a step
        assert routing.pairs == _moe_layers(rcfg) * B * rcfg.moe.top_k * (
            rcfg.frontend_prefix + S + 2 * N_DECODE)
    assert routing.differing == 0


@pytest.mark.parametrize("name,which", MODELS)
def test_bf16_prefill_and_decode_match_reference(name, which, monkeypatch):
    """bf16: the routing may differ at near ties; the differing pairs are
    bounded, and the logits are compared with the port routed as the
    reference (its top-k given the reference's ids)."""
    routing = _Routing(monkeypatch)
    rm, rp, pm, pp, rcfg = _models(name, which, jnp.bfloat16, torch.bfloat16)
    toks = np.random.default_rng(3).integers(0, rcfg.vocab_size, (B, S)).astype(np.int32)
    rf, pf = _frontend(rcfg, 7)
    max_seq = MAX_SEQ + rcfg.frontend_prefix
    with _x32():
        rl, rc = rm.prefill(rp, jnp.asarray(toks), max_seq, rf)
    routing.feed(routing.take())
    pl, pc = pm.prefill(pp, torch.from_numpy(toks), max_seq, pf)
    assert pl.dtype == torch.bfloat16
    tol = BF16_TOL_OF.get(name, BF16_LOGIT_TOL)
    np.testing.assert_allclose(_logits(pl), _logits(rl), rtol=0,
                               atol=tol * float(np.abs(_logits(rl)).max()))
    tok = jnp.argmax(rl[:, -1], -1).astype(jnp.int32)[:, None]
    decode = jax.jit(rm.decode_step)
    for _ in range(N_DECODE):
        with _x32():
            rl, rc = decode(rp, rc, tok)
        routing.feed(routing.take())
        pl, pc = pm.decode_step(pp, pc, torch.from_numpy(np.array(tok)))
        np.testing.assert_allclose(_logits(pl), _logits(rl), rtol=0,
                                   atol=tol * float(np.abs(_logits(rl)).max()))
        tok = jnp.argmax(rl[:, -1], -1).astype(jnp.int32)[:, None]
    assert routing.differing <= BF16_MAX_DIFFERING * routing.pairs


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("name", NAMES)
def test_loss_fn_ce_and_aux_match_reference(name, compute):
    jdt, tdt = (jnp.float32, torch.float32) if compute == "f32" else (jnp.bfloat16, torch.bfloat16)
    rm, rp, pm, pp, rcfg = _models(name, "reduced", jdt, tdt, seed=4)
    toks = np.random.default_rng(4).integers(0, rcfg.vocab_size, (B, 32)).astype(np.int32)
    rf, pf = _frontend(rcfg, 8)
    rb, pb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if rf is not None:
        rb["frontend"], pb["frontend"] = rf, pf
    with _x32():
        want, wm = rm.loss_fn(rp, rb)
    got, gm = pm.loss_fn(pp, pb)
    rtol = 1e-5 if compute == "f32" else 2e-2
    np.testing.assert_allclose(float(gm["ce"]), float(wm["ce"]), rtol=rtol)
    np.testing.assert_allclose(float(gm["aux"]), float(wm["aux"]), rtol=rtol)
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)
    if rcfg.moe is None:
        assert float(gm["aux"]) == 0.0
    else:  # one load-balance loss an MoE layer, each near 1 for a balanced router
        assert 0.5 * _moe_layers(rcfg) < float(gm["aux"]) < 2.0 * _moe_layers(rcfg)


def _step_clock(monkeypatch, SV):
    """``serve()``'s clock, made to advance 1 s at each reading: the
    prefill reads it twice and each pass of the decode loop once, so a
    fault time lands on a fixed decode step whatever the host's load."""
    import itertools
    import types

    ticks = itertools.count()
    monkeypatch.setattr(SV, "time", types.SimpleNamespace(monotonic=lambda: float(next(ticks))))


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "arctic-480b"])
def test_moe_serve_with_faults_gives_the_fault_free_tokens(name, monkeypatch):
    """The MoE path has no atomics and no data-dependent order, so a
    faulted ``serve()`` (restores and re-decoded tokens) gives the
    fault-free run's tokens.  The faults fall on decode steps of a
    simulated clock (:func:`_step_clock`)."""
    from repro_torch.launch import serve as SV

    _step_clock(monkeypatch, SV)
    cfg = configs.get(name).reduced()
    kw = dict(requests=3, prompt_len=12, gen=24, snapshot_every=4, seed=5, device="cpu")
    clean = SV.serve(cfg, **kw)
    t0, dt = clean["prefill_s"], clean["decode_s"]
    faulted = SV.serve(cfg, fault_times=[0.0] + [t0 + f * dt for f in (0.3, 0.5, 0.7)], **kw)
    assert faulted["faults"] >= 1
    assert torch.equal(faulted["tokens"], clean["tokens"])


@pytest.mark.parametrize("name", ["jamba-1.5-large-398b"] + list(FRONTENDS))
def test_hybrid_and_frontend_serve_with_faults_gives_the_fault_free_tokens(name, monkeypatch):
    """Jamba (its Mamba states restored from the snapshots) and the frontend
    families (the prefix in the cache): a faulted ``serve()`` gives the
    fault-free run's tokens.  The faults fall on decode steps of a
    simulated clock (:func:`_step_clock`)."""
    from repro_torch.launch import serve as SV

    _step_clock(monkeypatch, SV)
    cfg = configs.get(name).reduced()
    kw = dict(requests=3, prompt_len=12, gen=24, snapshot_every=4, seed=5, device="cpu")
    clean = SV.serve(cfg, **kw)
    t0, dt = clean["prefill_s"], clean["decode_s"]
    faulted = SV.serve(cfg, fault_times=[0.0] + [t0 + f * dt for f in (0.3, 0.5, 0.7)], **kw)
    assert faulted["faults"] >= 1 and faulted["redecoded"] >= 1
    assert torch.equal(faulted["tokens"], clean["tokens"])


# --------------------------------------------------------------------------- #
# The frontend batches of the drivers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", FRONTENDS)
def test_serve_draws_the_reference_frontend_bit_for_bit(name, monkeypatch):
    """The reference's server draws the prompts, then ``jnp.asarray(
    rng.standard_normal((B, prefix, D)) * 0.02, jnp.bfloat16)``: at full
    size (8 requests, 576 or 64 rows of d_model 4096 or 2048) the port's
    ``draw_requests`` gives the same bits, and ``serve()`` passes them to
    the prefill (at ``reduced()``)."""
    from repro_torch.launch import serve as SV

    cfg = configs.get(name)
    got = SV.draw_requests(cfg, 8, 64, seed=3)
    rng = np.random.default_rng(3)
    with _x32():
        toks = jnp.asarray(rng.integers(0, cfg.vocab_size, (8, 64)), jnp.int32)
        fe = jnp.asarray(rng.standard_normal((8, cfg.frontend_prefix, cfg.d_model)) * 0.02,
                         jnp.bfloat16)
    assert got["tokens"].dtype == torch.int32
    assert np.array_equal(got["tokens"].numpy(), np.asarray(toks))
    assert got["frontend"].dtype == torch.bfloat16
    assert np.array_equal(got["frontend"].view(torch.int16).numpy(),
                          np.asarray(fe).view(np.int16))
    seen = []
    prefill = LanguageModel.prefill

    def spy(self, params, tokens, max_seq, frontend=None):
        seen.append(frontend)
        return prefill(self, params, tokens, max_seq, frontend)

    monkeypatch.setattr(LanguageModel, "prefill", spy)
    small = cfg.reduced()
    SV.serve(small, requests=2, prompt_len=6, gen=3, seed=4, device="cpu")
    want = SV.draw_requests(small, 2, 6, seed=4)["frontend"]
    assert len(seen) == 1 and torch.equal(seen[0], want)


def test_train_feeds_the_reference_frontend_batches(monkeypatch):
    """``launch.train`` on llava-next ``reduced()`` builds the reference
    driver's dataset (its ``frontend_prefix`` and ``d_model``): every
    step's batch, ``frontend`` included, is the reference's."""
    from repro.data.pipeline import SyntheticLMDataset as RData
    from repro_torch.launch import train as TR

    cfg = configs.get("llava-next-mistral-7b").reduced()
    batches = []
    loss_fn = LanguageModel.loss_fn

    def spy(self, params, batch):
        batches.append({k: v.clone() for k, v in batch.items()})
        return loss_fn(self, params, batch)

    monkeypatch.setattr(LanguageModel, "loss_fn", spy)
    res = TR.train(cfg, steps=2, batch=2, seq=16, seed=9, device="cpu", log=lambda _: None)
    assert len(res["losses"]) == 2 and all(np.isfinite(v) for v in res["losses"].values())
    ref = RData(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2, seed=9,
                frontend_prefix=cfg.frontend_prefix, d_model=cfg.d_model)
    assert len(batches) == 2
    for k, b in enumerate(batches):
        want = ref.batch(k)
        assert set(b) == {"tokens", "frontend"}
        assert tuple(b["frontend"].shape) == (2, cfg.frontend_prefix, cfg.d_model)
        for key in b:
            assert np.array_equal(b[key].numpy(), want[key]), (k, key)
