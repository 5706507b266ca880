"""The port's checkpoint substrate on the CPU: the reference's store,
async and buddy tests (``tests/test_checkpoint.py``) on the port, and the
two stores against each other: the same files, byte for byte, and each
restoring the other's steps (bfloat16 leaves: the port restores the
reference's files, which the reference's own restore cannot)."""

import json
import os
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointStore as RefStore
from repro_torch.checkpoint import (
    AsyncCheckpointer,
    BuddyMemoryCheckpoint,
    CheckpointStore,
    latest_step,
)
from repro_torch.checkpoint.store import flatten_with_keys, map_with_keys


@pytest.fixture
def tree():
    return {
        "params": {
            "w": torch.arange(24.0, dtype=torch.float32).reshape(4, 6),
            "b": torch.ones(2048, dtype=torch.float32) * 0.25,
        },
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _leaves(t):
    return list(flatten_with_keys(t).values())


class TestStore:
    def test_roundtrip_raw(self, tmp_path, tree):
        store = CheckpointStore(str(tmp_path), codec="raw")
        store.save(3, tree)
        back = store.restore(3, target=tree)
        for a, b in zip(_leaves(back), _leaves(tree)):
            assert a.dtype == b.dtype and torch.equal(a, b)

    def test_roundtrip_int8(self, tmp_path, tree):
        store = CheckpointStore(str(tmp_path), codec="int8")
        m = store.save(3, tree)
        assert m["stored_bytes"] < m["raw_bytes"]
        back = store.restore(3, target=tree)
        np.testing.assert_allclose(back["params"]["b"].numpy(), 0.25, atol=0.25 / 100)
        # small tensors and ints stored raw => exact
        assert torch.equal(back["step"], tree["step"])
        assert torch.equal(back["params"]["w"], tree["params"]["w"])

    def test_delta_codec(self, tmp_path, tree):
        store = CheckpointStore(str(tmp_path), codec="int8_delta")
        store.save(1, tree)
        tree2 = map_with_keys(
            lambda _, x: x + 1e-4 if x.dtype == torch.float32 else x, tree
        )
        store.save(2, tree2, prev_tree=tree)
        back = store.restore(2, target=tree, prev_tree=tree)
        np.testing.assert_allclose(
            back["params"]["b"].numpy(), tree2["params"]["b"].numpy(), atol=1e-6
        )

    def test_delta_restore_needs_prev(self, tmp_path, tree):
        store = CheckpointStore(str(tmp_path), codec="int8_delta")
        store.save(2, tree, prev_tree=tree)
        with pytest.raises(ValueError, match="previous checkpoint"):
            store.restore(2, target=tree)

    def test_restore_without_target_is_flat_on_device(self, tmp_path, tree):
        store = CheckpointStore(str(tmp_path), codec="int8")
        store.save(1, tree)
        flat = store.restore(1, device="cpu")
        assert sorted(flat) == ["params/b", "params/w", "step"]
        assert all(v.device.type == "cpu" for v in flat.values())
        assert flat["step"].dtype == torch.int32 and flat["params/b"].shape == (2048,)

    def test_restore_needs_a_device_without_cuda(self, tmp_path, tree, monkeypatch):
        """Without a target and without ``device``, restore resolves the
        device as every entry point does: without CUDA it raises the
        port's own error before it reads a file; ``device="cpu"`` still
        restores, and a target's devices need no ``device``."""
        store = CheckpointStore(str(tmp_path), codec="int8")
        store.save(1, tree)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            store.restore(1)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            store.restore(99)
        flat = store.restore(1, device="cpu")
        assert torch.equal(flat["params/w"], tree["params"]["w"])
        back = store.restore(1, target=tree)
        assert torch.equal(back["step"], tree["step"])

    def test_latest_step_ignores_staging(self, tmp_path, tree):
        store = CheckpointStore(str(tmp_path))
        store.save(5, tree)
        os.makedirs(os.path.join(str(tmp_path), "step_000000009.tmp-dead"))
        assert latest_step(str(tmp_path)) == 5

    def test_corruption_detected(self, tmp_path, tree):
        store = CheckpointStore(str(tmp_path))
        store.save(5, tree)
        d = os.path.join(str(tmp_path), "step_000000005")
        victim = [f for f in os.listdir(d) if f.endswith(".npy")][0]
        path = os.path.join(d, victim)
        arr = np.load(path)
        arr.reshape(-1)[0] += 1
        np.save(path, arr)
        with pytest.raises(IOError, match="corruption"):
            store.restore(5, target=tree)

    def test_gc_keeps_newest(self, tmp_path, tree):
        store = CheckpointStore(str(tmp_path))
        for s in (1, 2, 3, 4):
            store.save(s, tree)
        store.gc(keep=2)
        assert latest_step(str(tmp_path)) == 4
        assert not os.path.exists(os.path.join(str(tmp_path), "step_000000001"))
        assert store.steps() == [3, 4]

    def test_manifest_sidecar_written_and_checked(self, tmp_path, tree):
        store = CheckpointStore(str(tmp_path))
        store.save(4, tree)
        d = os.path.join(str(tmp_path), "step_000000004")
        assert os.path.exists(os.path.join(d, "manifest.crc"))
        # rot the manifest bytes: the sidecar catches it before JSON does
        with open(os.path.join(d, "manifest.json"), "a") as f:
            f.write(" ")
        with pytest.raises(IOError, match="manifest corruption"):
            store.restore(4, target=tree)

    def test_steps_lists_committed_only(self, tmp_path, tree):
        store = CheckpointStore(str(tmp_path))
        for s in (3, 1, 7):
            store.save(s, tree)
        os.makedirs(os.path.join(str(tmp_path), "step_000000009.tmp-dead"))
        assert store.steps() == [1, 3, 7]

    def test_restore_latest_skips_truncated_shard(self, tmp_path, tree):
        store = CheckpointStore(str(tmp_path))
        store.save(1, tree)
        store.save(2, tree)
        d = os.path.join(str(tmp_path), "step_000000002")
        victim = sorted(f for f in os.listdir(d) if f.endswith(".npy"))[0]
        with open(os.path.join(d, victim), "r+b") as f:
            f.truncate(10)  # npy magic cut short
        with pytest.warns(RuntimeWarning, match="skipping unusable"):
            got = store.restore_latest(target=tree)
        assert got is not None
        step, back = got
        assert step == 1
        assert torch.equal(back["params"]["w"], tree["params"]["w"])

    def test_restore_latest_skips_crc_mismatch(self, tmp_path, tree):
        store = CheckpointStore(str(tmp_path))
        store.save(1, tree)
        store.save(2, tree)
        d = os.path.join(str(tmp_path), "step_000000002")
        victim = [f for f in os.listdir(d) if f.endswith(".npy")][0]
        path = os.path.join(d, victim)
        arr = np.load(path)
        arr.reshape(-1)[0] += 1
        np.save(path, arr)
        with pytest.warns(RuntimeWarning):
            got = store.restore_latest(target=tree)
        assert got is not None and got[0] == 1

    def test_restore_latest_none_when_nothing_survives(self, tmp_path, tree):
        store = CheckpointStore(str(tmp_path))
        assert store.restore_latest() is None  # empty root
        store.save(1, tree)
        d = os.path.join(str(tmp_path), "step_000000001")
        os.remove(os.path.join(d, "manifest.json"))
        with pytest.warns(RuntimeWarning):
            assert store.restore_latest(device="cpu") is None

    def test_restore_latest_prefers_newest_valid(self, tmp_path, tree):
        store = CheckpointStore(str(tmp_path))
        for s in (1, 2, 3):
            store.save(s, tree)
        got = store.restore_latest(target=tree)
        assert got is not None and got[0] == 3

    def test_restore_casts_to_target_dtype(self, tmp_path, tree):
        store = CheckpointStore(str(tmp_path), codec="int8")
        store.save(1, tree)
        target = map_with_keys(lambda _, x: x.to(torch.float64), tree)
        back = store.restore(1, target=target)
        assert all(v.dtype == torch.float64 for v in _leaves(back))

    def test_bfloat16_is_refused(self, tmp_path):
        """bfloat16 leaves are stored now: raw under the int8 codec too (the
        reference's codec takes f32 / f16 only), restored bit for bit, with
        the manifest's dtype "bfloat16"."""
        store = CheckpointStore(str(tmp_path), codec="int8")
        w = (torch.arange(2048, dtype=torch.float32) / 7 - 100).to(torch.bfloat16)
        m = store.save(1, {"w": w})
        assert m["stored_bytes"] == m["raw_bytes"] == 2 * 2048
        with open(os.path.join(store._dir(1), "manifest.json")) as f:
            entry = json.load(f)["leaves"]["w"]
        assert entry["codec"] == "raw" and entry["dtype"] == "bfloat16"
        back = store.restore(1, target={"w": torch.zeros(2048, dtype=torch.bfloat16)})
        assert back["w"].dtype == torch.bfloat16
        assert torch.equal(back["w"].view(torch.int16), w.view(torch.int16))
        flat = store.restore(1, device="cpu")
        assert torch.equal(flat["w"].view(torch.int16), w.view(torch.int16))


class TestAsync:
    def test_durability_and_metrics(self, tmp_path, tree):
        ac = AsyncCheckpointer(CheckpointStore(str(tmp_path), codec="int8"))
        c_block = ac.save(11, tree)
        assert c_block >= 0.0
        ac.wait()
        assert ac.durable_step == 11
        m = ac.metrics
        assert m["c_full"] >= m["c_block"]
        assert set(m) == {"t_snapshot", "t_total", "raw_bytes", "stored_bytes",
                          "c_block", "c_full"}
        assert m["stored_bytes"] < m["raw_bytes"]

    def test_serialized_inflight(self, tmp_path, tree):
        ac = AsyncCheckpointer(CheckpointStore(str(tmp_path)), keep=3)
        for s in (1, 2, 3):
            ac.save(s, tree)
        ac.wait()
        assert ac.durable_step == 3

    def test_snapshot_is_taken_before_save_returns(self, tmp_path, tree):
        store = CheckpointStore(str(tmp_path))
        ac = AsyncCheckpointer(store)
        ac.save(1, tree)
        tree["params"]["w"].add_(100.0)  # the caller's next step
        ac.wait()
        back = store.restore(1, target=tree)
        assert torch.equal(back["params"]["w"], torch.arange(24.0).reshape(4, 6))

    def test_gc_after_drain_keeps_newest(self, tmp_path, tree):
        store = CheckpointStore(str(tmp_path))
        ac = AsyncCheckpointer(store, keep=2)
        for s in (1, 2, 3, 4):
            ac.save(s, tree)
        ac.wait()
        assert store.steps() == [3, 4]

    def test_drain_error_surfaces_on_wait(self, tmp_path, tree):
        blocker = tmp_path / "file"
        blocker.write_text("not a directory")
        ac = AsyncCheckpointer(CheckpointStore(str(blocker)))
        ac.save(1, tree)
        with pytest.raises(OSError):
            ac.wait()
        assert ac.durable_step is None
        ac.wait()  # the error is raised once

    def test_drain_base_exception_surfaces_on_wait(self, tmp_path, tree, monkeypatch):
        class Stop(BaseException):
            pass

        def write(step, snap):
            raise Stop()

        store = CheckpointStore(str(tmp_path))
        monkeypatch.setattr(store, "write", write)
        ac = AsyncCheckpointer(store)
        ac.save(1, tree)
        with pytest.raises(Stop):
            ac.wait()
        assert ac.durable_step is None


@pytest.mark.parametrize("codec", ["int8", "int8_delta"])
def test_raw_keys_are_stored_raw_under_every_codec(tmp_path, codec):
    """``raw_keys``: the leaves it accepts skip the codec (the train driver
    keeps AdamW's second moments so) and come back bit for bit; the others
    are coded."""
    rng = np.random.default_rng(4)
    tree = {"m": torch.from_numpy(rng.standard_normal(4096).astype(np.float32)),
            "v": torch.from_numpy((rng.standard_normal(4096) ** 2 * 1e-6).astype(np.float32))}
    prev = {k: x * 0.9 for k, x in tree.items()} if codec == "int8_delta" else None
    st = CheckpointStore(str(tmp_path), codec=codec, raw_keys=lambda k: k == "v")
    st.save(1, tree, prev_tree=prev)
    with open(os.path.join(tmp_path, "step_000000001", "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    assert leaves["v"]["codec"] == "raw" and leaves["m"]["codec"] == codec
    got = st.restore(1, target=tree, prev_tree=prev)
    assert torch.equal(got["v"], tree["v"])
    assert not torch.equal(got["m"], tree["m"])


class TestBuddy:
    def test_buddy_survives_node_loss(self, tree):
        bm = BuddyMemoryCheckpoint(n_nodes=4)
        bm.save(9, tree, rank=2)
        got = bm.restore(2, lost=True)
        assert got is not None and got[0] == 9
        assert torch.equal(got[1]["params"]["w"], tree["params"]["w"])
        assert bm.latest_step(2) == 9

    def test_snapshots_are_copies(self, tree):
        bm = BuddyMemoryCheckpoint(n_nodes=2)
        bm.save(1, tree, rank=0)
        tree["params"]["w"].add_(1.0)
        own, buddy = bm.restore(0), bm.restore(0, lost=True)
        assert torch.equal(own[1]["params"]["w"], buddy[1]["params"]["w"])
        assert not torch.equal(own[1]["params"]["w"], tree["params"]["w"])
        assert own[1]["params"]["w"].data_ptr() != buddy[1]["params"]["w"].data_ptr()

    def test_missing_returns_none(self):
        bm = BuddyMemoryCheckpoint(n_nodes=2)
        assert bm.restore(0) is None

    @pytest.mark.parametrize("lost", [False, True])
    def test_failed_save_keeps_the_previous_snapshot(self, tree, lost):
        """A copy that fails part way (here a leaf that is no array) leaves
        the rank's previous snapshot and its replica in place, as the
        reference's save does."""
        bm = BuddyMemoryCheckpoint(n_nodes=2)
        bm.save(1, tree, rank=0)
        bad = {"params": {"w": tree["params"]["w"] + 1.0, "z": object()}}
        with pytest.raises(TypeError):
            bm.save(2, bad, rank=0)
        got = bm.restore(0, lost=lost)
        assert got is not None and got[0] == 1
        assert torch.equal(got[1]["params"]["w"], tree["params"]["w"])


# --------------------------------------------------------------------------- #
# The port's store against the JAX store
# --------------------------------------------------------------------------- #
CODECS = ["raw", "int8", "int8_delta"]


def _np_tree(seed: int):
    """Nested dicts and a list; f32, f16 and int32 leaves; a leaf under
    1024 elements; leaves whose length is not a multiple of 256."""
    rng = np.random.default_rng(seed)
    return {
        "b": {"w": rng.standard_normal((48, 40)).astype(np.float32),
              "n": rng.standard_normal(1000).astype(np.float32)},
        "a": [rng.standard_normal(3000).astype(np.float16),
              (rng.standard_normal((17, 1040)) * 1e-3).astype(np.float32)],
        "step": np.array(seed, np.int32),
        "ids": rng.integers(0, 99, 2048).astype(np.int32),
    }


def _next(t, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (x * (1 + 1e-3 * rng.standard_normal(x.shape))).astype(x.dtype)
        if x.dtype.kind == "f" else x, t)


def _torch(t):
    return jax.tree.map(torch.from_numpy, t)


def _jax(t):
    return jax.tree.map(jnp.asarray, t)


def _step_files(root, step):
    d = os.path.join(root, f"step_{step:09d}")
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("codec", CODECS)
def test_files_byte_identical_to_jax_store(tmp_path, codec):
    t1, t2 = _np_tree(1), _next(_np_tree(1), 2)
    ref = RefStore(str(tmp_path / "ref"), codec)
    port = CheckpointStore(str(tmp_path / "port"), codec)
    ref.save(1, _jax(t1))
    ref.save(2, _jax(t2), prev_tree=_jax(t1))
    port.save(1, _torch(t1))
    port.save(2, _torch(t2), prev_tree=_torch(t1))
    for step in (1, 2):
        want, got = _step_files(ref.root, step), _step_files(port.root, step)
        assert sorted(got) == sorted(want)
        assert "manifest.json" in got and "manifest.crc" in got and len(got) == 8
        for f in want:
            assert got[f] == want[f], f


@pytest.mark.parametrize("codec", CODECS)
def test_port_restores_jax_steps(tmp_path, codec):
    t1, t2 = _np_tree(3), _next(_np_tree(3), 4)
    ref = RefStore(str(tmp_path), codec)
    ref.save(1, _jax(t1))
    ref.save(2, _jax(t2), prev_tree=_jax(t1))
    want = ref.restore(2, target=jax.eval_shape(lambda: _jax(t2)), prev_tree=_jax(t1))
    back = CheckpointStore(str(tmp_path), codec).restore(
        2, target=_torch(t2), prev_tree=_torch(t1))
    for k, w in flatten_with_keys(want).items():
        g = flatten_with_keys(back)[k]
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("codec", CODECS)
def test_jax_store_restores_port_steps(tmp_path, codec):
    t1, t2 = _np_tree(5), _next(_np_tree(5), 6)
    port = CheckpointStore(str(tmp_path), codec)
    port.save(1, _torch(t1))
    port.save(2, _torch(t2), prev_tree=_torch(t1))
    want = port.restore(2, target=_torch(t2), prev_tree=_torch(t1))
    back = RefStore(str(tmp_path), codec).restore(
        2, target=jax.eval_shape(lambda: _jax(t2)), prev_tree=_jax(t1))
    for k, w in flatten_with_keys(want).items():
        np.testing.assert_array_equal(np.asarray(flatten_with_keys(back)[k]), w.numpy())


def _bf16_tree(seed: int):
    """(the reference's leaves, the port's): bfloat16 leaves of the same
    bits (one of them 2048 elements, above the codec's threshold) beside an
    f32 leaf the int8 codecs encode."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((64, 32)) * 3).astype(ml_dtypes.bfloat16)
    b = rng.standard_normal(300).astype(ml_dtypes.bfloat16)
    f = rng.standard_normal(4096).astype(np.float32)

    def bf16(a):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)

    return ({"p": {"w": jnp.asarray(w), "b": jnp.asarray(b)}, "f": jnp.asarray(f)},
            {"p": {"w": bf16(w), "b": bf16(b)}, "f": torch.from_numpy(f)})


@pytest.mark.parametrize("codec", CODECS)
def test_bf16_files_byte_identical_to_jax_store(tmp_path, codec):
    """A bfloat16 leaf saved by the port is the reference store's file byte
    for byte (the ``'<V2'`` records ``np.save`` writes for ml_dtypes'
    bfloat16), and so is the manifest: dtype "bfloat16", the same crc."""
    rt, pt = _bf16_tree(7)
    RefStore(str(tmp_path / "ref"), codec).save(1, rt)
    CheckpointStore(str(tmp_path / "port"), codec).save(1, pt)
    want, got = _step_files(str(tmp_path / "ref"), 1), _step_files(str(tmp_path / "port"), 1)
    assert sorted(got) == sorted(want)
    for f in want:
        assert got[f] == want[f], f
    leaves = json.loads(got["manifest.json"])["leaves"]
    assert leaves["p/w"]["dtype"] == leaves["p/b"]["dtype"] == "bfloat16"
    assert leaves["p/w"]["codec"] == "raw"


@pytest.mark.parametrize("codec", CODECS)
def test_port_restores_jax_bf16_step(tmp_path, codec):
    """The port restores the reference's bfloat16 files bit for bit, into a
    target and without one."""
    rt, pt = _bf16_tree(8)
    RefStore(str(tmp_path), codec).save(3, rt)
    store = CheckpointStore(str(tmp_path), codec)
    for back in (store.restore(3, target=pt), store.restore(3, device="cpu")):
        flat = flatten_with_keys(back)
        for k, w in flatten_with_keys(pt).items():
            g = flat[k]
            assert g.dtype == w.dtype, k
            if w.dtype == torch.bfloat16:
                assert torch.equal(g.view(torch.int16), w.view(torch.int16)), k


def test_jax_store_cannot_restore_its_bf16_step(tmp_path):
    """Pinned: the reference's own restore fails on its bfloat16 file
    (``np.load`` gives ``|V2`` records and ``astype`` to bfloat16 has no cast
    function), which the port's restore does not copy.  A change to the
    reference that mends it shows here."""
    rt, _ = _bf16_tree(9)
    ref = RefStore(str(tmp_path), "raw")
    ref.save(1, rt)
    with pytest.raises(ValueError, match="cast"):
        ref.restore(1, target=jax.eval_shape(lambda: rt))


def test_flatten_order_matches_jax():
    t = _np_tree(0)
    t["z"] = {"b": [np.zeros(1), (np.ones(2), np.ones(3))], "a": None}
    want = [
        "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(t)[0]
    ]
    assert list(flatten_with_keys(t)) == want


# --------------------------------------------------------------------------- #
# The chip-smoke state: SmolLM-135M's parameter shapes
# --------------------------------------------------------------------------- #
def test_smollm_param_shapes_match_reference_model():
    from repro.configs import get
    from repro.models.transformer import LanguageModel
    from repro_torch.configs.smollm_135m import param_shapes

    with jax.enable_x64(True):
        ref = LanguageModel(get("smollm-135m")).abstract_params()
    want = {k: tuple(v.shape) for k, v in flatten_with_keys(ref).items()}
    got = param_shapes()
    assert got == want
    assert list(got) == list(want)
    assert all(str(v.dtype) == "float32" for v in flatten_with_keys(ref).values())
    assert sum(int(np.prod(s)) for s in got.values()) == 134_515_008
    assert sum(1 for s in got.values() if np.prod(s) >= 1024) == 10


# --------------------------------------------------------------------------- #
# The training state: an AdamWState NamedTuple under "opt"
# --------------------------------------------------------------------------- #
def _ref_train_state(quantize=False):
    """The reference's SmolLM-135M reduced training state past step 0, with
    numpy leaves."""
    from repro import configs as RC
    from repro.models.transformer import LanguageModel as RModel
    from repro.optim import adamw as RA

    params = RModel(RC.get("smollm-135m").reduced()).init(jax.random.PRNGKey(0))
    opt = RA.adamw_init(params, quantize=quantize)
    g = jax.tree.map(lambda p: jnp.full_like(p, 0.01), params)
    params, opt, _ = RA.adamw_update(g, opt, params, 1e-3)
    return jax.tree.map(np.array, {"params": params, "opt": opt})


class _OptState(NamedTuple):  # the layout of the AdamW state
    step: Any
    moments: Any


def test_namedtuple_round_trips(tmp_path):
    """A NamedTuple is rebuilt as its own type (``type(t)(generator)``
    raised a TypeError) and its fields keyed ``.<name>``."""
    AdamWState = _OptState
    st = {"opt": AdamWState(step=torch.tensor(3, dtype=torch.int32),
                            moments={"w": {"m": torch.ones(2048), "v": torch.zeros(2048)}}),
          "params": {"w": torch.arange(2048.0)}}
    assert list(flatten_with_keys(st)) == ["opt/.step", "opt/.moments/w/m",
                                           "opt/.moments/w/v", "params/w"]
    doubled = map_with_keys(lambda _, x: x * 2, st)
    assert type(doubled["opt"]) is AdamWState and int(doubled["opt"].step) == 6
    for codec in ("raw", "int8"):
        store = CheckpointStore(str(tmp_path / codec), codec)
        store.save(1, st)
        back = store.restore(1, target=st)
        assert type(back["opt"]) is AdamWState
        assert back["opt"].step.dtype == torch.int32 and int(back["opt"].step) == 3
        assert torch.equal(back["params"]["w"], st["params"]["w"]) or codec == "int8"
        assert torch.equal(back["opt"].moments["w"]["m"], st["opt"].moments["w"]["m"])
    bm = BuddyMemoryCheckpoint()
    bm.save(4, st)
    assert type(bm.restore(0, lost=True)[1]["opt"]) is AdamWState


@pytest.mark.parametrize("quantize", [False, True])
def test_train_state_key_paths_are_the_reference(quantize):
    from repro.checkpoint.store import _flatten_with_keys as ref_flatten
    from repro_torch.models import train_state_from_jax

    ref = _ref_train_state(quantize)
    want = list(ref_flatten(ref))
    got = list(flatten_with_keys(train_state_from_jax(ref, device="cpu")))
    assert got == want
    assert "opt/.step" in got
    assert any(k.startswith("opt/.moments/blocks/0/mixer/wq/") for k in got)


@pytest.mark.parametrize("codec", ["raw", "int8"])
def test_train_state_files_and_restores_across_stores(tmp_path, codec):
    from repro_torch.models import train_state_from_jax
    from repro_torch.optim import AdamWState

    ref_np = _ref_train_state()
    port = train_state_from_jax(ref_np, device="cpu")
    jx = jax.tree.map(jnp.asarray, ref_np)
    RefStore(str(tmp_path / "ref"), codec).save(5, jx)
    CheckpointStore(str(tmp_path / "port"), codec).save(5, port)
    want, got = _step_files(str(tmp_path / "ref"), 5), _step_files(str(tmp_path / "port"), 5)
    assert sorted(got) == sorted(want) and "opt__.step.npy" in got
    for f in want:
        assert got[f] == want[f], f
    # each store restores the other's step
    back = CheckpointStore(str(tmp_path / "ref"), codec).restore(5, target=port)
    assert isinstance(back["opt"], AdamWState)
    rback = RefStore(str(tmp_path / "port"), codec).restore(
        5, target=jax.eval_shape(lambda: jx))
    mine = CheckpointStore(str(tmp_path / "port"), codec).restore(5, target=port)
    for k, w in flatten_with_keys(jax.tree.map(np.asarray, rback)).items():
        assert np.array_equal(flatten_with_keys(back)[k].numpy(), w), k
        assert np.array_equal(flatten_with_keys(mine)[k].numpy(), w), k
