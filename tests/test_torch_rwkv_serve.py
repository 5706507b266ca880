"""The port's RWKV6 serving path (``repro_torch.models`` with the ``rwkv``
time mix and ``rwkv_cm`` channel mix, ``repro_torch.launch``) against the
reference's ``LanguageModel`` on the CPU, on ``rwkv6-7b.reduced()`` (hd
16) and on a width cut that keeps the published head dim (hd 64, d_model
512 = 8 heads, d_ff 1792 = the published 3.5 ratio, decay LoRA 64, 2
layers, vocab 512).  Weights are the reference's ``init`` converted by
``params_from_jax``, after ``u``, ``w0``, ``mu`` and ``ln`` are drawn from
a seed (the reference's init makes ``u`` and ``w0`` zeros and ``mu`` /
``ln`` constant, which would leave the bonus term and the per-channel
decays untested); tokens come from numpy.

Tolerances, measured on the CPU before they were set (three seeds each):
* f32 compute, after prefill: logits within 2e-5 (measured up to 8.9e-6
  at hd 64); the WKV state within 1e-4 (measured up to 3.9e-5, |state|
  up to 40); ``last`` / ``cm_last`` (bf16) within one bf16 ulp or 1e-5.
* f32 compute, one decode step from the reference's own cache: 1e-5
  (measured up to 3.8e-6).
* f32 compute, four decode steps each from its own cache: 5e-3, greedy
  tokens equal.  ``last`` / ``cm_last`` are bf16; an f32 value within
  rounding noise of a bf16 rounding boundary rounds the other way (1-3 of
  2,048 entries after this prefill), which moves the next logits by up to
  1.6e-3 (measured).
* bf16 compute: logits within 5e-2 * max|logit| and a relative L2 error
  of 5e-2.  bf16 rounds at other places in XLA and torch: each bf16 path
  sits 1.8-2.8% (max, of max|logit|) and 1.8-2.5% (L2) from the f32
  logits, and the port's as far from the reference's; this is 2x that.
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
from repro_torch.kernels import rwkv6 as W
from repro_torch.launch import serve as SV
from repro_torch.models import LanguageModel, RuntimeFlags, params_from_jax

B, S, MAX_SEQ, N_DECODE = 2, 48, 64, 4
PREFILL_TOL, STATE_TOL, SAME_CACHE_TOL, OWN_CACHE_TOL = 2e-5, 1e-4, 1e-5, 5e-3
BF16_TOL = 5e-2
#: the width cut: the published head dim and d_ff ratio at d_model 512
WIDTH = dict(num_layers=2, d_model=512, num_heads=8, num_kv_heads=8, d_ff=1792,
             vocab_size=512)


def _x32():
    """JAX's default 32-bit mode for every call into the reference."""
    return jax.enable_x64(False)


def _cfgs(which: str):
    """(reference config, port config)."""
    if which == "width":
        return (dataclasses.replace(RC.get("rwkv6-7b"), **WIDTH),
                dataclasses.replace(configs.get("rwkv6-7b"), **WIDTH))
    return RC.get("rwkv6-7b").reduced(), configs.get("rwkv6-7b").reduced()


def _seeded_tree(tree, seed: int):
    """The reference's params as numpy, with the time mix's ``u`` ~ 0.5
    N(0, 1), ``w0`` ~ U(-5, 1) (decays exp(-e) ... 0.993), ``mu`` ~ U(0,
    1), ``ln`` ~ 1 + 0.1 N(0, 1) and the channel mix's ``mu`` ~ U(0, 1)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.array, tree)
    for b in tree["blocks"]:
        m = b["mixer"]
        m["u"] = (rng.standard_normal(m["u"].shape) * 0.5).astype(np.float32)
        m["w0"] = rng.uniform(-5, 1, m["w0"].shape).astype(np.float32)
        m["mu"] = rng.uniform(0, 1, m["mu"].shape).astype(np.float32)
        m["ln"] = (1 + 0.1 * rng.standard_normal(m["ln"].shape)).astype(np.float32)
        b["mlp"]["mu"] = rng.uniform(0, 1, b["mlp"]["mu"].shape).astype(np.float32)
    return tree


def _leaf(x) -> torch.Tensor:
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _cache_to_torch(cache):
    return {"pos": torch.tensor(int(cache["pos"]), dtype=torch.int32),
            "blocks": tuple({k: _leaf(v) for k, v in b.items()} for b in cache["blocks"])}


def _bf16_bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().astype(np.int32)
    return np.array(x).view(np.int16).astype(np.int32)


def _logits(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _models(which, jdt, tdt, seed=1):
    rcfg, cfg = _cfgs(which)
    rm = RModel(rcfg, flags=RFlags(compute_dtype=jdt))
    pm = LanguageModel(cfg, RuntimeFlags(compute_dtype=tdt))
    with _x32():
        rp = _seeded_tree(rm.init(jax.random.PRNGKey(seed)), seed + 10)
    return rm, jax.tree.map(jnp.asarray, rp), pm, params_from_jax(rp, device="cpu"), rcfg


# --------------------------------------------------------------------------- #
# Parameters and caches
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("which", ["width", "reduced"])
def test_init_and_params_from_jax_keep_the_reference_tree(which):
    rcfg, cfg = _cfgs(which)
    with _x32():
        rp = RModel(rcfg).init(jax.random.PRNGKey(0))
        want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
                for path, leaf in jax.tree_util.tree_flatten_with_path(rp)[0]}
    conv = flatten_with_keys(params_from_jax(jax.tree.map(np.array, rp), device="cpu"))
    assert list(conv) == list(want)
    for k, v in conv.items():
        assert v.dtype == torch.float32 and np.array_equal(v.numpy(), np.asarray(want[k])), k
    mine = flatten_with_keys(LanguageModel(cfg).init(torch.Generator().manual_seed(0)))
    assert list(mine) == list(want)
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
           {k: tuple(v.shape) for k, v in want.items()}
    assert all(v.dtype == torch.float32 for v in mine.values())
    assert sum(v.numel() for v in mine.values()) == cfg.param_count()
    # the reference's init laws for the f32-kept leaves
    blk = LanguageModel(cfg).init(torch.Generator().manual_seed(0))["blocks"][0]
    assert bool((blk["mixer"]["mu"] == 0.5).all()) and bool((blk["mlp"]["mu"] == 0.5).all())
    assert not blk["mixer"]["u"].any() and not blk["mixer"]["w0"].any()
    assert bool((blk["mixer"]["ln"] == 1).all())


def test_cast_params_keeps_the_reference_f32_leaves():
    _, cfg = _cfgs("reduced")
    m = LanguageModel(cfg)
    cast = flatten_with_keys(m.cast_params(m.init(torch.Generator().manual_seed(2))))
    f32 = {k for k, v in cast.items() if v.dtype == torch.float32}
    assert f32 == {"final_norm"} | {f"blocks/0/{k}" for k in (
        "mixer/ln", "mixer/mu", "mixer/u", "mixer/w0", "mixer_norm", "mlp/mu", "mlp_norm")}
    assert all(v.dtype == torch.bfloat16 for k, v in cast.items() if k not in f32)


@pytest.mark.parametrize("which", ["width", "reduced"])
def test_cache_struct_matches_the_reference(which):
    rcfg, cfg = _cfgs(which)
    with _x32():
        want = jax.tree_util.tree_flatten_with_path(RModel(rcfg).cache_struct(3, 40))[0]
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            (tuple(s.shape), str(s.dtype)) for path, s in want}
    cache = LanguageModel(cfg).init_cache(3, 40, device="cpu")
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in flatten_with_keys(cache).items()}
    assert got == want
    assert all(v.device.type == "cpu" and not v.any() for v in flatten_with_keys(cache).values())


def test_init_cache_runs_on_cuda_unless_told_otherwise(monkeypatch):
    """Without a device the cache goes to the current CUDA device; without
    CUDA that raises instead of falling back to the CPU."""
    _, cfg = _cfgs("reduced")
    m = LanguageModel(cfg)
    cpu = m.init_cache(2, 16, device="cpu")
    assert all(v.device.type == "cpu" for v in flatten_with_keys(cpu).values())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.init_cache(2, 16)
    smollm = LanguageModel(configs.get("smollm-135m").reduced())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        smollm.init_cache(2, 16)


def test_serve_needs_a_device_without_cuda(monkeypatch):
    """serve() resolves its device as every entry point does: without CUDA
    and without ``device`` it raises the port's own error before it builds
    the model."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_model(cfg):
        raise AssertionError("serve() built the model before resolving its device")

    monkeypatch.setattr(SV, "build_model", no_model)
    for name in ("rwkv6-7b", "smollm-135m"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SV.serve(configs.get(name).reduced(), requests=1, prompt_len=4, gen=2)


def test_params_from_jax_needs_a_device_without_cuda(monkeypatch):
    """params_from_jax resolves its device as every entry point does:
    without CUDA and without ``device`` it raises the port's own error;
    ``device="cpu"`` still converts."""
    tree = {"blocks": ({"w": np.arange(6, dtype=np.float32).reshape(2, 3)},),
            "embed": np.ones((4, 2), np.float32)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax(tree)
    conv = params_from_jax(tree, device="cpu")
    assert conv["embed"].device.type == "cpu"
    assert np.array_equal(conv["blocks"][0]["w"].numpy(), tree["blocks"][0]["w"])


# --------------------------------------------------------------------------- #
# Prefill and decode against the reference model
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("which", ["width", "reduced"])
def test_f32_prefill_and_decode_match_reference(which):
    rm, rp, pm, pp, rcfg = _models(which, jnp.float32, torch.float32)
    V = rcfg.vocab_size
    toks = np.random.default_rng(2).integers(0, V, (B, S)).astype(np.int32)
    n0 = W.wkv6_bhsd.launches
    with _x32():
        rl, rc = rm.prefill(rp, jnp.asarray(toks), MAX_SEQ)
    pl, pc = pm.prefill(pp, torch.from_numpy(toks), MAX_SEQ)
    assert pl.shape == (B, 1, V) and pl.dtype == torch.float32
    np.testing.assert_allclose(_logits(pl), _logits(rl), atol=PREFILL_TOL, rtol=0)
    assert int(pc["pos"]) == S and pc["pos"].dtype == torch.int32
    blk = pc["blocks"][0]
    assert set(blk) == {"state", "last", "cm_last"}
    want = rc["blocks"][0]
    assert blk["state"].dtype == torch.float32
    np.testing.assert_allclose(blk["state"].numpy(), np.asarray(want["state"]),
                               atol=STATE_TOL, rtol=0)
    for key in ("last", "cm_last"):
        got = blk[key]
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == tuple(want[key].shape)
        ulps = np.abs(_bf16_bits(got) - _bf16_bits(want[key]))
        near = np.abs(got.float().numpy() - np.asarray(want[key], np.float32)) <= 1e-5
        assert bool(((ulps <= 1) | near).all()), f"{key}: {int(ulps.max())} ulp"
    tok = jnp.argmax(rl[:, -1], -1).astype(jnp.int32)[:, None]
    for _ in range(N_DECODE):
        synced = _cache_to_torch(rc)  # the reference's cache: one step's math alone
        with _x32():
            rl, rc = rm.decode_step(rp, rc, tok)
        sl, _ = pm.decode_step(pp, synced, torch.from_numpy(np.array(tok)))
        pl, pc = pm.decode_step(pp, pc, torch.from_numpy(np.array(tok)))
        np.testing.assert_allclose(_logits(sl), _logits(rl), atol=SAME_CACHE_TOL, rtol=0)
        np.testing.assert_allclose(_logits(pl), _logits(rl), atol=OWN_CACHE_TOL, rtol=0)
        assert np.array_equal(_logits(pl).argmax(-1), _logits(rl).argmax(-1))
        tok = jnp.argmax(rl[:, -1], -1).astype(jnp.int32)[:, None]
    assert int(pc["pos"]) == S + N_DECODE
    assert W.wkv6_bhsd.launches == n0  # CPU tensors launch no kernel


@pytest.mark.parametrize("which", ["width", "reduced"])
def test_bf16_prefill_and_decode_match_reference(which):
    rm, rp, pm, pp, rcfg = _models(which, jnp.bfloat16, torch.bfloat16)
    toks = np.random.default_rng(3).integers(0, rcfg.vocab_size, (B, S)).astype(np.int32)
    with _x32():
        rl, rc = rm.prefill(rp, jnp.asarray(toks), MAX_SEQ)
    pl, pc = pm.prefill(pp, torch.from_numpy(toks), MAX_SEQ)
    assert pl.dtype == torch.bfloat16

    def close(got, want):
        g, w = _logits(got), _logits(want)
        assert np.abs(g - w).max() <= BF16_TOL * np.abs(w).max()
        assert np.linalg.norm(g - w) <= BF16_TOL * np.linalg.norm(w)

    close(pl, rl)
    tok = jnp.argmax(rl[:, -1], -1).astype(jnp.int32)[:, None]
    for _ in range(N_DECODE):
        with _x32():
            rl, rc = rm.decode_step(rp, rc, tok)
        pl, pc = pm.decode_step(pp, pc, torch.from_numpy(np.array(tok)))
        close(pl, rl)
        tok = jnp.argmax(rl[:, -1], -1).astype(jnp.int32)[:, None]


def test_decode_chains_to_a_longer_prefill():
    """Prefill of S tokens then decode of the next ones gives the logits of
    a prefill over all of them (f32): the cache carries the state, the
    time-mix and the channel-mix shifts across calls."""
    _, cfg = _cfgs("reduced")
    m = LanguageModel(cfg, RuntimeFlags(compute_dtype=torch.float32))
    p = m.init(torch.Generator().manual_seed(3))
    for b in p["blocks"]:  # exercise the bonus and the decays
        g = torch.Generator().manual_seed(4)
        b["mixer"]["u"] = torch.randn(b["mixer"]["u"].shape, generator=g) * 0.5
        b["mixer"]["w0"] = torch.rand(b["mixer"]["w0"].shape, generator=g) * 6 - 5
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 20))
                            .astype(np.int32))
    full, _ = m.prefill(p, toks, 24)
    logits, cache = m.prefill(p, toks[:, :16], 24)
    for t in range(16, 20):
        logits, cache = m.decode_step(p, cache, toks[:, t:t + 1])
    # decode shifts in the bf16-rounded last tokens, prefill the f32 ones
    # (measured 8.4e-3, max|logit| 3.0)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), atol=2e-2, rtol=0)
    assert int(cache["pos"]) == 20


# --------------------------------------------------------------------------- #
# The server
# --------------------------------------------------------------------------- #
def test_serve_with_faults_gives_the_fault_free_tokens():
    """Faults restore the last snapshot and re-decode; the in-place state,
    ``last`` and ``cm_last`` must be copied on snapshot and on restore for
    the replay to give the same tokens."""
    _, cfg = _cfgs("reduced")
    kw = dict(requests=3, prompt_len=12, gen=24, snapshot_every=4, seed=5, device="cpu")
    clean = SV.serve(cfg, **kw)
    assert clean["tokens"].shape == (3, 24) and clean["tokens"].dtype == torch.int32
    assert clean["faults"] == 0 and clean["decode_steps"] == 23
    t0, dt = clean["prefill_s"], clean["decode_s"]
    times = [0.0] + [t0 + f * dt for f in (0.3, 0.5, 0.7)]
    faulted = SV.serve(cfg, fault_times=times, **kw)
    assert faulted["faults"] >= 1
    assert torch.equal(faulted["tokens"], clean["tokens"])
    assert faulted["decode_steps"] == 23 + faulted["redecoded"]


def test_snapshot_copies_every_cache_leaf():
    _, cfg = _cfgs("reduced")
    m = LanguageModel(cfg)
    cache = m.init_cache(2, 8, device="cpu")
    for v in flatten_with_keys(cache).values():
        v.fill_(1)
    snap = SV._clone_cache(cache)
    assert set(flatten_with_keys(snap)) == {"pos", "blocks/0/cm_last", "blocks/0/last",
                                            "blocks/0/state"}
    for v in flatten_with_keys(cache).values():
        v.fill_(2)
    assert all(bool((v == 1).all()) for v in flatten_with_keys(snap).values())
    SV._copy_cache(cache, snap)
    assert all(bool((v == 1).all()) for v in flatten_with_keys(cache).values())


def test_serve_cli_on_cpu(capsys):
    res = SV.main(["--arch", "rwkv6-7b", "--device", "cpu", "--requests", "2",
                   "--prompt-len", "8", "--gen", "6", "--seed", "1"])
    assert res["tokens"].shape == (2, 6)
    assert "generated (2, 6) tokens" in capsys.readouterr().out
