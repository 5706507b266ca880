"""The port's data pipeline, gradient compression and training-state
conversion against the reference's on the CPU: ``SyntheticLMDataset``
batches and ``PrefetchIterator`` order array for array, the compress
functions (codes and scales equal, decoded values rtol 1e-6), and
``train_state_from_jax`` on the reference's f32 and quantized states; and
the reference's ``tests/test_data_optim.py`` on the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.data.pipeline import PrefetchIterator as RPrefetch
from repro.data.pipeline import SyntheticLMDataset as RData
from repro.models.transformer import LanguageModel as RModel
from repro.optim import adamw as RA
from repro.optim import compress as RCMP
from repro_torch.checkpoint.store import flatten_with_keys, map_with_keys
from repro_torch.data import PrefetchIterator, SyntheticLMDataset
from repro_torch.models import train_state_from_jax
from repro_torch.optim import (
    AdamWState,
    adamw_init,
    adamw_update,
    compress_gradients,
    cosine_schedule,
    decompress_gradients,
    ef_compress_step,
    global_norm,
)

DATASETS = [
    dict(vocab_size=1000, seq_len=64, global_batch=8, seed=3),
    dict(vocab_size=49152, seq_len=128, global_batch=4, seed=0),
    dict(vocab_size=137, seq_len=16, global_batch=8, seed=3, n_shards=4, shard=2),
    dict(vocab_size=100, seq_len=8, global_batch=2, frontend_prefix=4, d_model=16, seed=9),
]


@pytest.mark.parametrize("kw", DATASETS)
def test_batches_equal_reference(kw):
    port, ref = SyntheticLMDataset(**kw), RData(**kw)
    assert port.local_batch == ref.local_batch
    for step in (0, 1, 17, 1000):
        got, want = port.batch(step), ref.batch(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (step, k)


def test_prefetch_order_equals_reference():
    kw = dict(vocab_size=100, seq_len=8, global_batch=2, seed=1)
    it, rit = PrefetchIterator(SyntheticLMDataset(**kw), start_step=5, depth=2), RPrefetch(
        RData(**kw), start_step=5, depth=2)
    try:
        for _ in range(6):
            (s, b), (rs, rb) = next(it), next(rit)
            assert s == rs and np.array_equal(b["tokens"], rb["tokens"])
    finally:
        it.close()
        rit.close()


def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((17, 33)) * 0.01).astype(np.float32),
            "b": rng.standard_normal(300).astype(np.float32),
            "z": np.zeros((4, 64), np.float32),
            "one": rng.standard_normal(1).astype(np.float32)}


def test_compress_gradients_equal_reference():
    g = _grad_tree(0)
    want = RCMP.compress_gradients(jax.tree.map(jnp.asarray, g))
    got = compress_gradients({k: torch.from_numpy(v) for k, v in g.items()})
    for k in g:
        (q, s), (rq, rs) = got[k], want[k]
        assert q.dtype == torch.int8 and tuple(q.shape) == rq.shape
        assert np.array_equal(q.numpy(), np.asarray(rq)), k
        np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-6, err_msg=k)
    back = decompress_gradients(got, {k: torch.from_numpy(v) for k, v in g.items()})
    rback = RCMP.decompress_gradients(want, jax.tree.map(jnp.asarray, g))
    for k in g:
        assert back[k].shape == g[k].shape
        np.testing.assert_allclose(back[k].numpy(), np.asarray(rback[k]), rtol=1e-6, atol=0)


def test_bf16_gradients_compress_as_f32():
    g = torch.from_numpy(_grad_tree(1)["w"]).to(torch.bfloat16)
    want = RCMP.compress_gradients({"w": jnp.asarray(g.float().numpy()).astype(jnp.bfloat16)})
    q, s = compress_gradients({"w": g})["w"]
    assert np.array_equal(q.numpy(), np.asarray(want["w"][0]))


def test_error_feedback_equals_reference_over_steps():
    g_np = [_grad_tree(10 + i) for i in range(3)]
    res = {k: torch.zeros(v.shape) for k, v in g_np[0].items()}
    rres = jax.tree.map(lambda v: jnp.zeros(v.shape, jnp.float32), g_np[0])
    for g in g_np:
        deq, res = ef_compress_step({k: torch.from_numpy(v) for k, v in g.items()}, res)
        rdeq, rres = RCMP.ef_compress_step(jax.tree.map(jnp.asarray, g), rres)
        for k in g:
            np.testing.assert_allclose(deq[k].numpy(), np.asarray(rdeq[k]), rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(res[k].numpy(), np.asarray(rres[k]), rtol=1e-5, atol=1e-9)
            assert res[k].dtype == torch.float32


@pytest.mark.parametrize("quantize", [False, True])
def test_train_state_from_jax_round_trips(quantize):
    cfg = RC.get("smollm-135m").reduced()
    params = RModel(cfg).init(jax.random.PRNGKey(0))
    opt = RA.adamw_init(params, quantize=quantize)
    # a state past step 0: moments that are not zero
    g = jax.tree.map(lambda p: jnp.ones_like(p) * 0.01, params)
    params, opt, _ = RA.adamw_update(g, opt, params, 1e-3)
    ref = jax.tree.map(np.array, {"params": params, "opt": opt})
    got = train_state_from_jax(ref, device="cpu")
    assert isinstance(got["opt"], AdamWState)
    assert got["opt"].step.dtype == torch.int32 and int(got["opt"].step) == 1
    want = flatten_with_keys(ref)
    flat = flatten_with_keys(got)
    assert list(flat) == list(want)
    assert "opt/.step" in flat and any(k.startswith("opt/.moments/") for k in flat)
    for k, w in want.items():
        assert flat[k].numpy().dtype == w.dtype and np.array_equal(flat[k].numpy(), w), k
    # and it trains on: one port update from the converted state
    p, o, _ = adamw_update(map_with_keys(lambda _, x: torch.full_like(x, 0.01), got["params"]),
                           got["opt"], got["params"], 1e-3)
    assert int(o.step) == 2


def test_train_state_from_jax_resolves_its_device(monkeypatch):
    ref = {"params": {"w": np.ones(3, np.float32)},
           "opt": RA.AdamWState(step=np.zeros((), np.int32),
                                moments={"w": {"m": np.zeros(3, np.float32),
                                               "v": np.zeros(3, np.float32)}})}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_state_from_jax(ref)
    assert train_state_from_jax(ref, device="cpu")["params"]["w"].device.type == "cpu"


# --------------------------------------------------------------------------- #
# tests/test_data_optim.py on the port
# --------------------------------------------------------------------------- #
class TestPipeline:
    def test_deterministic_resume(self):
        d = SyntheticLMDataset(1000, 64, 8, seed=3)
        assert np.array_equal(d.batch(17)["tokens"], d.batch(17)["tokens"])

    def test_steps_differ(self):
        d = SyntheticLMDataset(1000, 64, 8, seed=3)
        assert not np.array_equal(d.batch(1)["tokens"], d.batch(2)["tokens"])

    def test_shards_partition_global_batch(self):
        batches = [SyntheticLMDataset(1000, 16, 8, seed=3, n_shards=4, shard=i).batch(0)["tokens"]
                   for i in range(4)]
        assert all(b.shape == (2, 16) for b in batches)
        assert not np.array_equal(batches[0], batches[1])

    def test_tokens_in_vocab(self):
        t = SyntheticLMDataset(137, 32, 4, seed=0).batch(0)["tokens"]
        assert t.min() >= 0 and t.max() < 137

    def test_frontend_embeddings(self):
        assert SyntheticLMDataset(100, 8, 2, frontend_prefix=4, d_model=16).batch(0)[
            "frontend"].shape == (2, 4, 16)

    def test_prefetch_ordering(self):
        d = SyntheticLMDataset(100, 8, 2, seed=1)
        it = PrefetchIterator(d, start_step=5, depth=2)
        try:
            (s0, b0), (s1, _) = next(it), next(it)
            assert (s0, s1) == (5, 6)
            assert np.array_equal(b0["tokens"], d.batch(5)["tokens"])
        finally:
            it.close()


class TestAdamW:
    def _params(self):
        rng = np.random.default_rng(0)
        return {"w": torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32)),
                "b": torch.zeros(16)}

    def test_descends_quadratic(self):
        params = self._params()
        state = adamw_init(params)

        def loss(p):
            return sum(((a - 1.0) ** 2).sum() for a in p.values())

        l0 = float(loss(params))
        for _ in range(50):
            live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            grads = dict(zip(live, torch.autograd.grad(loss(live), list(live.values()))))
            params, state, _ = adamw_update(grads, state, params, lr=0.05, weight_decay=0.0)
        assert float(loss(params)) < l0 * 0.2

    def test_quantized_matches_fp32_closely(self):
        params = self._params()
        s_fp, s_q = adamw_init(params), adamw_init(params, quantize=True)
        p_fp, p_q = params, params
        rng = np.random.default_rng(1)
        for _ in range(10):
            g = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
                 for k, v in params.items()}
            p_fp, s_fp, _ = adamw_update(g, s_fp, p_fp, lr=1e-2)
            p_q, s_q, _ = adamw_update(g, s_q, p_q, lr=1e-2)
        diff = max(float((p_fp[k] - p_q[k]).abs().max()) for k in params)
        scale = max(float(v.abs().max()) for v in p_fp.values())
        assert diff < 0.05 * scale

    def test_clipping(self):
        params = self._params()
        g = {k: torch.full(v.shape, 100.0) for k, v in params.items()}
        _, _, m = adamw_update(g, adamw_init(params), params, lr=1e-3, clip_norm=1.0)
        assert float(m["grad_norm"]) > 1.0

    def test_cosine_schedule(self):
        assert float(cosine_schedule(0, 1.0, warmup=10, total=100)) == 0.0
        assert float(cosine_schedule(10, 1.0, warmup=10, total=100)) == pytest.approx(1.0)
        assert float(cosine_schedule(100, 1.0, warmup=10, total=100)) == pytest.approx(0.1)

    def test_global_norm(self):
        assert float(global_norm({"a": torch.ones(3) * 2.0})) == pytest.approx(np.sqrt(12.0))


@pytest.mark.parametrize("quantize", [False, True])
def test_adamw_bf16_leaf_clips_in_f32_as_the_reference(quantize):
    """A bf16 leaf whose gradient norm (~300) is far above ``clip_norm``:
    the reference's ``g * scale`` promotes the bf16 gradient to f32 before
    the clip, so the port must too.  Two steps; moments at the f32
    tolerance of ``tests/test_torch_train.py`` (rtol 1e-6, atol 1e-6 of
    the leaf's max; int8 codes within one level), the bf16 params equal.
    A bf16 clip puts the first ``m`` up to ~1.7e-3 (rel) off.

    The gradients are multiples of 1/8 in [-4, 4], so every square and
    every partial sum of the norm is exact in f32 and the clip scale is
    the same bits on both sides.  With standard-normal gradients the two
    norms differ by summation order alone (XLA's f32 reduce against
    torch's, 1.0e-6 rel on this leaf), which moves ``v`` by twice that."""
    rng = np.random.default_rng(26)
    p_bits = (rng.standard_normal((64, 256)) * 0.05).astype(np.float32)
    rp = {"w": jnp.asarray(p_bits, jnp.bfloat16)}
    pp = {"w": torch.from_numpy(p_bits).to(torch.bfloat16)}
    rs, ps = RA.adamw_init(rp, quantize=quantize), adamw_init(pp, quantize=quantize)
    for step in range(2):
        g32 = (rng.integers(-32, 33, (64, 256)) / 8.0).astype(np.float32)
        rg = {"w": jnp.asarray(g32, jnp.bfloat16)}
        pg = {"w": torch.from_numpy(g32).to(torch.bfloat16)}
        assert float(global_norm(pg)) > 250.0
        rp, rs, _ = RA.adamw_update(rg, rs, rp, jnp.float32(1e-3))
        pp, ps, _ = adamw_update(pg, ps, pp, torch.tensor(1e-3, dtype=torch.float32))
        assert pp["w"].dtype == torch.bfloat16
        np.testing.assert_array_equal(pp["w"].float().numpy(),
                                      np.asarray(rp["w"], np.float32))
        want = {k: np.asarray(v) for k, v in flatten_with_keys(
            jax.tree.map(np.array, rs.moments)).items()}
        got = flatten_with_keys(ps.moments)
        assert list(got) == list(want)
        for k, w in want.items():
            g = got[k].numpy()
            assert g.dtype == w.dtype, k
            if g.dtype == np.int8:
                assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1, k
            else:
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * np.abs(w).max(),
                                           err_msg=k)
