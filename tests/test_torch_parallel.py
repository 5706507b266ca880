"""The port's distributed layer (``repro_torch.parallel``,
``repro_torch.launch.{mesh,steps}``' sharding helpers, expert-parallel MoE,
ZeRO-1, ``dp_allreduce_int8``, ``CheckpointStore`` with ``shardings=``)
against the port on one rank and the JAX reference on one device, on the
CPU.

The multi-rank checks run in rank processes (``tests/_torch_dist_child.py``:
gloo, a file rendezvous under the test's directory, one torch thread a
rank, a time limit on the launch and on every collective); this process
starts no process group.  Two launches serve every check: the 2 x 2
``(data, model)`` mesh (4 ranks) and a 1 x 2 restore (2 ranks).  Inputs
come from numpy seeds and the reference's ``init`` (through
``params_from_jax``); each data rank takes its rows of one global batch.

Tolerances (f32):
* sharded loss against the port on one rank rtol 1e-6; last-position
  prefill logits within 1e-5 of max|logit|; against the reference on one
  device, the f32 tolerances of ``tests/test_torch_families.py`` (loss
  rtol 1e-5, prefill logits 1e-5 of max|logit|).  MoE capacity factor 4,
  the reference's sharded check's, so no pair drops in either layout.
* two ZeRO-1 train steps against the unsharded port step: losses rtol
  1e-5, every parameter within 1e-5 of the leaf's max|value|, every
  gradient leaf (the expert weights' too: an expert-parallel combine whose
  backward all-reduced would make them ``M`` times too large) within
  1e-5 of its max; replicated leaves and their moments bit-equal across
  the model ranks.  With int8 moments the same, but that the sharded
  gradients' last-bit differences may move a moment by one code level
  (the codes within one level of the unsharded step's; measured on 1 of
  16384 entries of Qwen3's embedding), and that entry's parameter by up to
  2 lr: at most 1e-4 of the parameters may lie past the tolerance.
* ``dp_allreduce_int8``, the sharded save / restore: bit-equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from _torch_dist_child import B, CODECS, LOSS_NAMES, LR, REGIMES, S, TOTAL, TRAIN_NAMES, launch
from repro import configs as RC
from repro.launch import steps as RS
from repro.models import moe as RMoE
from repro.models.layers import RuntimeFlags as RFlags
from repro.models.transformer import LanguageModel as RModel
from repro.optim.compress import _blockwise as r_blockwise
from repro.parallel import sharding as RSH
from repro_torch import configs
from repro_torch.checkpoint import CheckpointStore
from repro_torch.checkpoint.store import flatten_with_keys, map_with_keys
from repro_torch.launch import steps as PS
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import RuntimeFlags, params_from_jax
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.parallel import sharding as PSH

SHAPE, NAMES_AX = (2, 2), ("data", "model")
LOSS_RTOL, LOGIT_TOL, REF_RTOL, REF_LOGIT_TOL, STEP_TOL = 1e-6, 1e-5, 1e-5, 1e-5, 1e-5
#: with int8 moments, the share of parameters allowed past STEP_TOL (module
#: docstring; measured 1 of 16384 entries of Qwen3's embedding)
INT8_FAR_SHARE = 1e-4


def _x32():
    return jax.enable_x64(False)


def _rflags(cf=4.0):
    return RFlags(dense_attn_max=16, kv_chunk=8, moe_capacity_factor=cf,
                  compute_dtype=jnp.float32)


def _pflags(cf=4.0):
    return RuntimeFlags(dense_attn_max=16, kv_chunk=8, moe_capacity_factor=cf,
                        compute_dtype=torch.float32)


def _tokens(name: str, seed: int) -> np.ndarray:
    vocab = configs.get(name).reduced().vocab_size
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _np_params(name: str):
    """Seed-0 parameters with numpy leaves (the port's ``init``, whose tree
    and laws are the reference's): the reference takes them as they are,
    the port through ``params_from_jax``."""
    pm = PS.build_model(configs.get(name).reduced())
    return map_with_keys(lambda _, v: v.numpy(), pm.init(torch.Generator().manual_seed(0)))


def _ref_params(np_params):
    with _x32():
        return jax.tree.map(jnp.asarray, np_params)


def _spec_list(spec):
    return [list(a) if isinstance(a, tuple) else a for a in tuple(spec)]


def _state(params):
    """The sharded-save state: Qwen3's params and random f32 moments (seed
    7), and its 2 x 2 layout (params, ZeRO-1 moments; the step replicated)."""
    model = PS.build_model(configs.get("qwen3-moe-30b-a3b").reduced(), _pflags(),
                           Mesh(SHAPE, NAMES_AX))
    rng = np.random.default_rng(7)
    opt = adamw_init(params)
    moments = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32))
               for k, v in flatten_with_keys(opt.moments).items()}
    state = {"params": params,
             "opt": AdamWState(torch.tensor(3, dtype=torch.int32),
                               map_with_keys(lambda k, _: moments[k], opt.moments))}
    sh = {"params": PS.param_shardings(model),
          "opt": AdamWState(PSH.NamedSharding(model.rules.mesh, PSH.PartitionSpec()),
                            PS.moment_shardings(model, False))}
    specs = {k: _spec_list(v.spec) for k, v in flatten_with_keys(sh).items()}
    return state, specs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Write the inputs, run the 2 x 2 task and the 1 x 2 restore."""
    out = tmp_path_factory.mktemp("parallel")
    np_params = {}
    for name in sorted(set(LOSS_NAMES + TRAIN_NAMES)):
        np_params[name] = _np_params(name)
        torch.save(params_from_jax(np_params[name], "cpu"), out / f"params.{name}.pt")
        np.save(out / f"tokens.{name}.npy", _tokens(name, 11))
        for i in range(2):
            np.save(out / f"tokens.{name}.{i}.npy", _tokens(name, 20 + i))
    for r in range(4):
        x = np.random.default_rng(100 + r).standard_normal(1000).astype(np.float32) * (r + 1)
        np.save(out / f"allreduce_in.r{r}.npy", x)
    state, specs = _state(torch.load(out / "params.qwen3-moe-30b-a3b.pt"))
    torch.save(state, out / "state.pt")
    (out / "state_specs.json").write_text(json.dumps(specs))
    launch("parallel", 4, out)
    launch("restore", 2, out)
    res = [json.loads((out / f"result.r{r}.json").read_text()) for r in range(4)]
    return out, res, state, specs, np_params


# --------------------------------------------------------------------------- #
# (a) the tables and specs, no process group
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", list(RS.RULES_MODES))
@pytest.mark.parametrize("heads", [True, False])
def test_rules_tables_match_reference(mode, heads):
    for shape, names in ((SHAPE, NAMES_AX), ((2, 4, 4), ("pod", "data", "model")), ((4,), ("data",))):
        want = RSH.make_rules(AbstractMesh(shape, names), shard_heads=heads,
                              overrides=RS.RULES_MODES[mode])
        got = PSH.make_rules(Mesh(shape, names), shard_heads=heads,
                             overrides=PS.RULES_MODES[mode])
        assert dict(got.table) == dict(want.table)
        assert tuple(got.spec("batch", "heads", None)) == tuple(want.spec("batch", "heads", None))
        assert dict(got.with_overrides(ff=None).table) == dict(want.with_overrides(ff=None).table)
    assert PSH.logical_spec(None, "batch") == () and PSH.shard("x", got, "batch") == "x"
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16, "model": 16}


def _flat_logical(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_logical(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(tree, tuple) and not all(isinstance(a, (str, type(None))) for a in tree):
        out = {}
        for i, t in enumerate(tree):
            out.update(_flat_logical(t, f"{prefix}/{i}" if prefix else str(i)))
        return out
    return {prefix: tuple(tree)}


@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_param_and_cache_specs_match_reference(name):
    """``param_specs`` / ``cache_specs`` key by key, and ``abstract_params``
    (meta tensors) shape and dtype by key, at full size."""
    with _x32():
        rm = RModel(RC.get(name))
        want_p, want_c = _flat_logical(rm.param_specs()), _flat_logical(rm.cache_specs())
        ap = rm.abstract_params()
    pm = PS.build_model(configs.get(name))
    assert _flat_logical(pm.param_specs()) == want_p
    got_c = _flat_logical(pm.cache_specs())
    assert got_c == want_c
    got = flatten_with_keys(pm.abstract_params())
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(ap)[0]}
    assert set(got) == set(want) == set(want_p)
    for k, v in got.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == want[k].shape and str(v.dtype).split(".")[1] == want[k].dtype.name


def _spec_by_key(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec"))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            tuple(s.spec) for path, s in leaves}


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("name,cut", [(n, "reduced") for n in configs.ARCH_NAMES]
                         + [("qwen3-moe-30b-a3b", "full"), ("jamba-1.5-large-398b", "full"),
                            ("arctic-480b", "full")])
def test_tree_shardings_and_zero1_specs_match_reference(name, cut, quantized):
    """``fitted_sharding`` through ``tree_shardings`` and
    ``zero1_moment_specs`` on a (2, 2) mesh, spec for spec."""
    rcfg, pcfg = RC.get(name), configs.get(name)
    if cut == "reduced":
        rcfg, pcfg = rcfg.reduced(), pcfg.reduced()
    with _x32():
        rules = RSH.make_rules(AbstractMesh(SHAPE, NAMES_AX),
                               shard_heads=rcfg.shard_heads_ok(2))
        rm = RModel(rcfg, rules)
        ap, logical = rm.abstract_params(), rm.param_specs()
        want_p = _spec_by_key(RS.tree_shardings(ap, logical, rules))
        want_m = _spec_by_key(RS.zero1_moment_specs(ap, logical, rules, quantized))
    prules = PSH.make_rules(Mesh(SHAPE, NAMES_AX), shard_heads=pcfg.shard_heads_ok(2))
    pm = PS.build_model(pcfg)
    pap = pm.abstract_params()
    got_p = {k: tuple(v.spec) for k, v in flatten_with_keys(
        PS.tree_shardings(pap, pm.param_specs(), prules)).items()}
    got_m = {k: tuple(v.spec) for k, v in flatten_with_keys(
        PS.zero1_moment_specs(pap, pm.param_specs(), prules, quantized)).items()}
    assert got_p == want_p
    assert got_m == want_m


def test_the_ports_layout_shards_only_the_experts():
    """``build_model`` turns the dense entries off: every leaf but the
    expert weights is replicated over the model axis and, but for ZeRO-1's
    moments, over data."""
    pm = PS.build_model(configs.get("qwen3-moe-30b-a3b"), mesh=Mesh(SHAPE, NAMES_AX))
    fsdp = {"wi_gate": (None, "model", "data", None), "wi_up": (None, "model", "data", None),
            "wo": (None, "model", None, "data")}  # d_model -> data
    for k, sh in flatten_with_keys(PS.param_shardings(pm)).items():
        leaf = k.rsplit("/", 1)[-1]
        want = fsdp[leaf] if "/mlp/" in k and leaf in fsdp else (None,) * len(sh.spec)
        assert tuple(sh.spec) == want, k
    st = PS.build_model(configs.get("qwen3-moe-30b-a3b"), mesh=Mesh(SHAPE, NAMES_AX),
                        rules_mode="moe_stationary")
    flat = flatten_with_keys(PS.param_shardings(st))
    assert tuple(flat["blocks/0/mlp/wi_gate"].spec) == (None, "model", None, "data")
    assert tuple(flat["blocks/0/mlp/wo"].spec) == (None, "model", "data", None)
    assert tuple(flat["embed"].spec) == (None, None)


# --------------------------------------------------------------------------- #
# (b) sharded loss and prefill on 2 x 2
# --------------------------------------------------------------------------- #
def _port_one_rank(name, out, cf=4.0):
    pm = PS.build_model(configs.get(name).reduced(), _pflags(cf))
    params = torch.load(out / f"params.{name}.pt")
    toks = torch.from_numpy(np.load(out / f"tokens.{name}.npy"))
    return pm, params, toks


@pytest.mark.parametrize("name", LOSS_NAMES)
def test_sharded_loss_and_prefill_match_one_rank_and_reference(run, name):
    out, res, _, _, np_params = run
    pm, params, toks = _port_one_rank(name, out)
    loss, metrics, grads = PS._value_and_grad(pm, params, {"tokens": toks})
    for r in range(4):  # the global loss on every rank
        np.testing.assert_allclose(res[r][name]["loss"], float(loss), rtol=LOSS_RTOL)
        np.testing.assert_allclose(res[r][name]["aux"], float(metrics["aux"]), rtol=LOSS_RTOL)
    logits, _ = pm.prefill(params, toks, S + 8)
    want = logits[:, -1].numpy()
    rows = [np.load(out / f"prefill.{name}.r{r}.npy") for r in range(4)]
    assert np.array_equal(rows[0], rows[1]) and np.array_equal(rows[2], rows[3])  # model ranks
    got = np.concatenate([rows[0], rows[2]])  # data ranks 0 and 1
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL * scale)
    # every gradient leaf (expert weights included) against the one-rank port
    sharded = torch.load(out / f"grads.{name}.pt")
    for k, g in grads.items():
        tol = STEP_TOL * float(g.abs().max())
        np.testing.assert_allclose(sharded[k].numpy(), g.numpy(), rtol=0, atol=tol, err_msg=k)
    # the reference on one device
    with _x32():
        rm = RModel(RC.get(name).reduced(), flags=_rflags())
        rp = _ref_params(np_params[name])
        rloss, _ = rm.loss_fn(rp, {"tokens": jnp.asarray(toks.numpy())})
        rl, _ = rm.prefill(rp, jnp.asarray(toks.numpy()), S + 8)
    np.testing.assert_allclose(res[0][name]["loss"], float(rloss), rtol=REF_RTOL)
    rl = np.asarray(rl[:, -1], np.float32)
    np.testing.assert_allclose(got, rl, rtol=0, atol=REF_LOGIT_TOL * float(np.abs(rl).max()))


@pytest.mark.parametrize("where,name,mode", REGIMES)
def test_other_expert_regimes_match_one_rank(run, where, name, mode):
    """The weight-stationary experts (``moe_stationary``: ``expert_ff`` ->
    data, the token buffers gathered and the partial outputs
    reduce-scattered) on 2 x 2, and the one-group path on a data-only mesh
    of 4 (no model axis: the experts' data blocks gathered, FSDP or
    stationary): the global loss and every gradient leaf against the one
    rank port."""
    out, res, _, _, _ = run
    pm, params, toks = _port_one_rank(name, out)
    loss, _, grads = PS._value_and_grad(pm, params, {"tokens": toks})
    for r in range(4):
        np.testing.assert_allclose(res[r][f"{where}.{name}.{mode}"], float(loss), rtol=LOSS_RTOL)
    sharded = torch.load(out / f"grads.{where}.{name}.{mode}.pt")
    for k, g in grads.items():
        np.testing.assert_allclose(sharded[k].numpy(), g.numpy(), rtol=0,
                                   atol=STEP_TOL * float(g.abs().max()), err_msg=k)


# --------------------------------------------------------------------------- #
# (c) ZeRO-1 train steps on 2 x 2
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("quant", ["f32", "int8"])
@pytest.mark.parametrize("name", TRAIN_NAMES)
def test_zero1_train_steps_match_the_unsharded_step(run, name, quant):
    out, res, _, _, np_params = run
    tag = f"{name}.{quant}"
    pm = PS.build_model(configs.get(name).reduced(), _pflags())
    params = torch.load(out / f"params.{name}.pt")
    opt = adamw_init(params, quantize=quant == "int8")
    step = PS.build_train_step(pm, lr=LR, total_steps=TOTAL)
    losses = []
    for i in range(2):
        params, opt, m = step(params, opt, {"tokens": torch.from_numpy(
            np.load(out / f"tokens.{name}.{i}.npy"))})
        losses.append(float(m["loss"]))
    for r in range(4):
        np.testing.assert_allclose(res[r][tag]["losses"], losses, rtol=STEP_TOL)
    got = torch.load(out / f"trained.{tag}.pt", weights_only=False)  # written by a rank
    far = total = 0
    for k, v in flatten_with_keys(params).items():
        w = flatten_with_keys(got["params"])[k]
        off = (w - v).abs() > STEP_TOL * float(v.abs().max())
        if quant == "f32":
            assert not bool(off.any()), (k, float((w - v).abs().max()))
        far, total = far + int(off.sum()), total + v.numel()
    for k, v in flatten_with_keys(opt.moments).items():
        w = flatten_with_keys(got["opt"].moments)[k]
        if v.dtype == torch.int8:  # one code level at most
            assert int((w.int() - v.int()).abs().max()) <= 1, k
        else:
            np.testing.assert_allclose(w.numpy(), v.numpy(), rtol=0,
                                       atol=STEP_TOL * float(v.abs().max()) + 1e-30, err_msg=k)
    # int8 moments: a gradient's last-bit difference can move a moment by
    # one code level, and that parameter by up to 2 lr; the rest agree
    assert far <= INT8_FAR_SHARE * total, (far, total)
    assert int(got["opt"].step) == 2
    # the replicated leaves and their moments: the same bits on both model
    # ranks of each data rank
    assert res[0][tag]["replicated_digest"] == res[1][tag]["replicated_digest"]
    assert res[2][tag]["replicated_digest"] == res[3][tag]["replicated_digest"]


# --------------------------------------------------------------------------- #
# (d) dp_allreduce_int8 on 2 and 4 ranks
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("world", [2, 4])
def test_dp_allreduce_int8_is_the_rank_order_sum_on_every_rank(run, world):
    out = run[0]
    got = [np.load(out / f"allreduce{world}.r{r}.npy") for r in range(4)]
    xs = [np.load(out / f"allreduce_in.r{r}.npy") for r in range(4)]

    def round_trip(x):
        with _x32():
            q, s = r_blockwise(jnp.asarray(x))
            return (np.asarray(q, np.float32) * np.asarray(s)[:, None]).reshape(-1)[:x.size]

    groups = [[0, 1, 2, 3]] if world == 4 else [[0, 2], [1, 3]]  # the data axis of 2 x 2
    for g in groups:
        want = round_trip(xs[g[0]])
        for r in g[1:]:
            want = want + round_trip(xs[r])
        for r in g:
            assert got[r].dtype == np.float32
            assert np.array_equal(got[r], want), (world, r)


# --------------------------------------------------------------------------- #
# (f) the sharded save and its restores
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("codec", CODECS)
def test_sharded_save_writes_the_unsharded_bytes_and_restores_elastically(run, tmp_path, codec):
    out, _, state, specs, _ = run
    store = CheckpointStore(str(tmp_path / "full"), codec)
    store.save(3, state)
    d_sh, d_full = out / f"ckpt_{codec}" / "step_000000003", tmp_path / "full" / "step_000000003"
    names = sorted(p.name for p in d_full.iterdir())
    assert sorted(p.name for p in d_sh.iterdir()) == names
    for n in names:
        assert (d_sh / n).read_bytes() == (d_full / n).read_bytes(), n
    # one rank: the whole coded round trip
    want = store.restore(3, device="cpu")
    one = CheckpointStore(str(out / f"ckpt_{codec}"), codec).restore(3, device="cpu")
    assert set(one) == set(want)
    for k in want:
        assert torch.equal(one[k], want[k]), k
    # 1 x 2: each rank its block of the same
    mesh = Mesh((1, 2), NAMES_AX)
    for r in range(2):
        got = torch.load(out / f"restored_1x2.{codec}.r{r}.pt")
        coord = {"data": 0, "model": r}
        for k, v in want.items():
            sh = PSH.NamedSharding(mesh, PSH.PartitionSpec(*(
                tuple(a) if isinstance(a, list) else a for a in specs[k])))
            assert torch.equal(got[k], PSH.local_block(v, sh, coord)), (k, r)
    # the expert leaves really were split over the model axis
    wg = "params/blocks/0/mlp/wi_gate"
    assert got[wg].shape[1] == want[wg].shape[1] // 2


# --------------------------------------------------------------------------- #
# (g) capacity per data group
# --------------------------------------------------------------------------- #
def test_capacity_is_per_data_group(run):
    """With the config's capacity factor (1.25), the pairs dropped in each
    data group are those the reference drops on that group's tokens with
    ``C`` from the group's token count (``_capacity(T_l, ...)``)."""
    out, res, _, _, np_params = run
    name = "qwen3-moe-30b-a3b"
    rcfg = RC.get(name).reduced()
    toks = np.load(out / f"tokens.{name}.npy")
    calls = []
    top_k = jax.lax.top_k

    def spy(operand, k):
        vals, ids = top_k(operand, k)
        jax.debug.callback(lambda a: calls.append(np.asarray(a)), ids, ordered=True)
        return vals, ids

    E, K = rcfg.moe.num_experts, rcfg.moe.top_k
    T_l = (B // 2) * S
    C = RMoE._capacity(T_l, K, E, rcfg.moe.capacity_factor)
    jax.lax.top_k = spy
    try:
        with _x32():
            rm = RModel(rcfg, flags=_rflags(None))
            rp = _ref_params(np_params[name])
            want = []
            for d in range(2):  # each group's tokens alone: G = 1, T = T_l
                calls.clear()
                rm.loss_fn(rp, {"tokens": jnp.asarray(toks[d * (B // 2):(d + 1) * (B // 2)])})
                jax.effects_barrier()
                want.append([int(np.maximum(np.bincount(c.reshape(-1), minlength=E) - C, 0)
                                 .sum()) for c in calls])
    finally:
        jax.lax.top_k = top_k
    for r in range(4):
        assert res[r]["drops"] == want[res[r]["data_rank"]], r
    assert sum(map(sum, want)) > 0  # the factor drops pairs at this size
