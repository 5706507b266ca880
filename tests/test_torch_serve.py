"""The port's serving path (``repro_torch.models`` and
``repro_torch.launch``) against the reference's ``LanguageModel`` on the
CPU, on SmolLM-135M's width cut to 2 layers and a 512-token vocabulary,
and on the reference's ``reduced()`` config.  Weights are the reference's
``init`` converted by ``params_from_jax``; tokens come from numpy.

Tolerances, measured on the CPU before they were set:
* f32 compute, after prefill: logits within 1e-5 (measured 2.9e-6 at
  SmolLM's width; XLA's and torch's f32 products sum in other orders).
* f32 compute, one decode step from the reference's own cache: 1e-4
  (measured up to 6.4e-5).
* f32 compute, four decode steps each from its own cache: 1e-3, greedy
  tokens equal.  The cache is bf16; an f32 K/V entry that lands within
  rounding noise (~1e-6) of a bf16 rounding boundary rounds the other way
  (58 of 61,440 entries after this prefill), and one such entry moves
  the logits by up to ~1e-4 (measured up to 3.8e-4 over four steps).
* f32 compute, the prefill caches: every bf16 entry within one bf16 ulp
  of the reference's, or within 1e-5 (the f32 logits' tolerance): near 0
  the f32 noise of the K/V projection (measured up to 3.8e-6, for entries
  below 2.6e-4) spans more than one bf16 ulp.
* bf16 compute: logits within 2e-2 * max|logit|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.core import events as REV
from repro.models.layers import RuntimeFlags as RFlags
from repro.models.transformer import LanguageModel as RModel
from repro_torch import configs
from repro_torch.checkpoint.store import flatten_with_keys
from repro_torch.core import events as EV
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import serve as SV
from repro_torch.launch.steps import build_decode_step, build_model, build_prefill_step
from repro_torch.models import LanguageModel, RuntimeFlags, params_from_jax

B, S, MAX_SEQ, N_DECODE = 2, 64, 80, 4
IMPLS = ("dense", "chunked", "pallas")


def _x32():
    """JAX's default 32-bit mode for every call into the reference."""
    return jax.enable_x64(False)


def _cfgs(which: str):
    """(reference config, port config)."""
    if which == "width":
        return (dataclasses.replace(RC.get("smollm-135m"), num_layers=2, vocab_size=512),
                dataclasses.replace(configs.get("smollm-135m"), num_layers=2, vocab_size=512))
    return RC.get("smollm-135m").reduced(), configs.get("smollm-135m").reduced()


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _cache_to_torch(cache):
    return {"pos": torch.tensor(int(cache["pos"]), dtype=torch.int32),
            "blocks": tuple({k: torch.from_numpy(np.array(v).view(np.int16)).view(torch.bfloat16)
                             for k, v in b.items()} for b in cache["blocks"])}


def _bf16_bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().astype(np.int32)
    return np.array(x).view(np.int16).astype(np.int32)


def _logits(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# --------------------------------------------------------------------------- #
# Configs, conversion, traces
# --------------------------------------------------------------------------- #
def test_config_and_reduced_match_reference_field_for_field():
    ref, port = RC.get("smollm-135m"), configs.get("smollm-135m")
    for r, p in ((ref, port), (ref.reduced(), port.reduced())):
        assert dataclasses.asdict(p) == dataclasses.asdict(r)
        assert (p.resolved_head_dim, p.n_repeats, p.param_count()) == \
               (r.resolved_head_dim, r.n_repeats, r.param_count())
    assert port.param_count() == 134_515_008
    with pytest.raises(KeyError):
        configs.get("no-such-arch")


def test_rwkv_config_and_reduced_match_reference_field_for_field():
    ref, port = RC.get("rwkv6-7b"), configs.get("rwkv6-7b")
    for r, p in ((ref, port), (ref.reduced(), port.reduced())):
        assert dataclasses.asdict(p) == dataclasses.asdict(r)
        assert (p.resolved_head_dim, p.n_repeats, p.rwkv_heads, p.param_count()) == \
               (r.resolved_head_dim, r.n_repeats, r.rwkv_heads, r.param_count())
    assert port.param_count() == 7_534_546_944
    assert (port.num_layers, port.d_model, port.rwkv_heads, port.ssm.rwkv_head_dim,
            port.d_ff, port.vocab_size, port.tie_embeddings, port.param_dtype) == \
           (32, 4096, 64, 64, 14336, 65536, False, "float32")
    assert "rwkv6-7b" in configs.ARCH_NAMES


@pytest.mark.parametrize("name", RC.ARCH_NAMES)
def test_other_families_are_not_built(name):
    """Every config of the reference is built (the port's names are the
    reference's, in its order), under each remat policy of the reference
    (``test_torch_train.py`` holds the policies' gradients bit-equal); a
    policy the reference does not name is refused."""
    assert configs.ARCH_NAMES == list(RC.ARCH_NAMES)
    cfg = configs.get(name).reduced()
    for policy in ("none", "full", "dots"):
        model = LanguageModel(cfg, RuntimeFlags(remat_policy=policy))
        assert model.cfg is cfg and model.flags.remat_policy == policy
    with pytest.raises(ValueError, match="remat_policy"):
        LanguageModel(cfg, RuntimeFlags(remat_policy="offload"))


@pytest.mark.parametrize("which", ["width", "reduced"])
def test_init_and_params_from_jax_keep_the_reference_tree(which):
    rcfg, cfg = _cfgs(which)
    with _x32():
        rp = RModel(rcfg).init(jax.random.PRNGKey(0))
        want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
                for path, leaf in jax.tree_util.tree_flatten_with_path(rp)[0]}
    conv = flatten_with_keys(params_from_jax(_np_tree(rp), device="cpu"))
    assert list(conv) == list(want)
    for k, v in conv.items():
        assert v.dtype == torch.float32 and np.array_equal(v.numpy(), np.asarray(want[k])), k
    g = torch.Generator().manual_seed(0)
    mine = flatten_with_keys(LanguageModel(cfg).init(g))
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
           {k: tuple(v.shape) for k, v in want.items()}
    assert list(mine) == list(want)


def test_fault_trace_matches_reference_draws():
    for seed, mtbf in ((0, 4.0), (5, 0.25)):
        want = REV.make_event_trace(np.random.default_rng(seed + 3), horizon=600.0,
                                    mtbf=mtbf, recall=0.0, precision=1.0)
        assert SV.fault_trace(seed, mtbf) == [f.time for f in want.faults]
    for law, rlaw in ((EV.weibull(0.7), REV.weibull(0.7)), (EV.lognormal(1.0), REV.lognormal(1.0)),
                      (EV.uniform(), REV.uniform())):
        a = EV.make_event_trace(np.random.default_rng(9), 300.0, 2.0, 0.4, 0.7, window=1.5,
                                fault_dist=law)
        b = REV.make_event_trace(np.random.default_rng(9), 300.0, 2.0, 0.4, 0.7, window=1.5,
                                 fault_dist=rlaw)
        assert [(f.time, f.predicted) for f in a.faults] == \
               [(f.time, f.predicted) for f in b.faults]
        assert [(p.t0, p.fault_time) for p in a.predictions] == \
               [(p.t0, p.fault_time) for p in b.predictions]


# --------------------------------------------------------------------------- #
# Prefill and decode against the reference model
# --------------------------------------------------------------------------- #
def _models(which, impl, jdt, tdt):
    rcfg, cfg = _cfgs(which)
    rm = RModel(rcfg, flags=RFlags(attn_impl=impl, compute_dtype=jdt, kv_chunk=16))
    pm = LanguageModel(cfg, RuntimeFlags(attn_impl=impl, compute_dtype=tdt, kv_chunk=16))
    with _x32():
        rp = rm.init(jax.random.PRNGKey(1))
    return rm, rp, pm, params_from_jax(_np_tree(rp), device="cpu"), rcfg.vocab_size


@pytest.mark.parametrize("which", ["width", "reduced"])
@pytest.mark.parametrize("impl", IMPLS)
def test_f32_prefill_and_decode_match_reference(which, impl):
    rm, rp, pm, pp, V = _models(which, impl, jnp.float32, torch.float32)
    toks = np.random.default_rng(2).integers(0, V, (B, S)).astype(np.int32)
    f0, d0 = FA.flash_attention_bhsd.launches, DA.decode_attention_bhd.launches
    with _x32():
        rl, rc = rm.prefill(rp, jnp.asarray(toks), MAX_SEQ)
    pl, pc = pm.prefill(pp, torch.from_numpy(toks), MAX_SEQ)
    assert pl.shape == (B, 1, V) and pl.dtype == torch.float32
    np.testing.assert_allclose(_logits(pl), _logits(rl), atol=1e-5, rtol=0)
    assert int(pc["pos"]) == S and pc["pos"].dtype == torch.int32
    for key in ("k", "v"):
        want, got = rc["blocks"][0][key], pc["blocks"][0][key]
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == tuple(want.shape)
        ulps = np.abs(_bf16_bits(got) - _bf16_bits(want))
        near = np.abs(got.float().numpy() - np.asarray(want, np.float32)) <= 1e-5
        assert bool(((ulps <= 1) | near).all()), f"cache {key}: {int(ulps.max())} ulp"
        assert not got[:, :, S:].any()
    tok = jnp.argmax(rl[:, -1], -1).astype(jnp.int32)[:, None]
    for _ in range(N_DECODE):
        synced = _cache_to_torch(rc)  # the reference's cache: one step's math alone
        with _x32():
            rl, rc = rm.decode_step(rp, rc, tok)
        sl, _ = pm.decode_step(pp, synced, torch.from_numpy(np.array(tok)))
        pl, pc = pm.decode_step(pp, pc, torch.from_numpy(np.array(tok)))
        np.testing.assert_allclose(_logits(sl), _logits(rl), atol=1e-4, rtol=0)
        np.testing.assert_allclose(_logits(pl), _logits(rl), atol=1e-3, rtol=0)
        assert np.array_equal(_logits(pl).argmax(-1), _logits(rl).argmax(-1))
        tok = jnp.argmax(rl[:, -1], -1).astype(jnp.int32)[:, None]
    assert int(pc["pos"]) == S + N_DECODE
    # CPU tensors launch no kernel, whichever path
    assert (FA.flash_attention_bhsd.launches, DA.decode_attention_bhd.launches) == (f0, d0)


@pytest.mark.parametrize("which", ["width", "reduced"])
@pytest.mark.parametrize("impl", IMPLS)
def test_bf16_prefill_and_decode_match_reference(which, impl):
    rm, rp, pm, pp, V = _models(which, impl, jnp.bfloat16, torch.bfloat16)
    toks = np.random.default_rng(3).integers(0, V, (B, S)).astype(np.int32)
    with _x32():
        rl, rc = rm.prefill(rp, jnp.asarray(toks), MAX_SEQ)
    pl, pc = pm.prefill(pp, torch.from_numpy(toks), MAX_SEQ)
    assert pl.dtype == torch.bfloat16
    tol = 2e-2 * float(np.abs(_logits(rl)).max())
    np.testing.assert_allclose(_logits(pl), _logits(rl), atol=tol, rtol=0)
    tok = jnp.argmax(rl[:, -1], -1).astype(jnp.int32)[:, None]
    for _ in range(N_DECODE):
        with _x32():
            rl, rc = rm.decode_step(rp, rc, tok)
        pl, pc = pm.decode_step(pp, pc, torch.from_numpy(np.array(tok)))
        tol = 2e-2 * float(np.abs(_logits(rl)).max())
        np.testing.assert_allclose(_logits(pl), _logits(rl), atol=tol, rtol=0)
        tok = jnp.argmax(rl[:, -1], -1).astype(jnp.int32)[:, None]


def test_steps_cast_once_and_match_the_model():
    """The step functions of launch.steps give the model's numbers; a tree
    cast once (cast_params) is used as it is, without copies."""
    _, cfg = _cfgs("reduced")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(4))
    cast = model.cast_params(params)
    assert cast["blocks"][0]["mixer"]["wq"].dtype == torch.bfloat16
    assert cast["blocks"][0]["mixer_norm"].dtype == torch.float32
    assert cast["final_norm"].dtype == torch.float32
    again = model.cast_params(cast)
    assert all(a is b for a, b in zip(flatten_with_keys(again).values(),
                                      flatten_with_keys(cast).values()))
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12))
                            .astype(np.int32))
    l1, c1 = build_prefill_step(model, 20)(cast, {"tokens": toks})
    l2, c2 = model.prefill(params, toks, 20)
    assert torch.equal(l1, l2)
    t = l1[:, -1].argmax(-1).to(torch.int32)[:, None]
    d1, c1 = build_decode_step(model)(cast, c1, t)
    d2, c2 = model.decode_step(params, c2, t)
    assert torch.equal(d1, d2) and int(c1["pos"]) == 13


# --------------------------------------------------------------------------- #
# The server
# --------------------------------------------------------------------------- #
def test_serve_with_faults_gives_the_fault_free_tokens():
    """Faults restore the last snapshot and re-decode; the in-place cache
    must be copied on snapshot and on restore for the replay to give the
    same tokens."""
    _, cfg = _cfgs("reduced")
    kw = dict(requests=3, prompt_len=12, gen=24, snapshot_every=4, seed=5, device="cpu")
    clean = SV.serve(cfg, **kw)
    assert clean["tokens"].shape == (3, 24) and clean["tokens"].dtype == torch.int32
    assert clean["faults"] == 0 and clean["decode_steps"] == 23
    # faults spread over the fault-free run's decode, and one at its start
    t0, dt = clean["prefill_s"], clean["decode_s"]
    times = [0.0] + [t0 + f * dt for f in (0.3, 0.5, 0.7)]
    faulted = SV.serve(cfg, fault_times=times, **kw)
    assert faulted["faults"] >= 1
    assert torch.equal(faulted["tokens"], clean["tokens"])
    assert faulted["decode_steps"] == 23 + faulted["redecoded"]


def test_serve_cli_on_cpu(capsys):
    res = SV.main(["--device", "cpu", "--requests", "2", "--prompt-len", "8", "--gen", "6",
                   "--seed", "1"])
    assert res["tokens"].shape == (2, 6)
    assert "generated (2, 6) tokens" in capsys.readouterr().out
