"""Rank processes of the port's distributed tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_pp.py``).

``launch(task, world, out)`` starts ``world`` processes of this file, one a
rank, waits for them under a time limit and kills them all if it passes.
Each rank runs on the CPU with one torch thread, joins a gloo process
group through a file rendezvous in ``out`` (no TCP port is fixed), runs
``TASKS[task]`` and destroys the group.  The ranks read their inputs from
files the test wrote into ``out`` and write rank-tagged results there;
the test compares them.  No JAX here: the reference runs in the test.

    python tests/_torch_dist_child.py TASK RANK WORLD OUT
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: the configs of the sharded loss / prefill checks, and of the train steps
LOSS_NAMES = ("qwen3-moe-30b-a3b", "granite-8b", "rwkv6-7b", "jamba-1.5-large-398b")
#: the expert weights' other regime and the one-group path (a data-only
#: mesh): (mesh, config, rules mode) of the extra sharded loss checks
REGIMES = (("2x2", "qwen3-moe-30b-a3b", "moe_stationary"),
           ("2x2", "jamba-1.5-large-398b", "moe_stationary"),
           ("4", "qwen3-moe-30b-a3b", "baseline"),
           ("4", "qwen3-moe-30b-a3b", "moe_stationary"))
TRAIN_NAMES = ("qwen3-moe-30b-a3b", "smollm-135m")
B, S = 4, 32
LR, TOTAL = 1e-3, 20
CODECS = ("raw", "int8")
#: a rank's limit for each collective, and the launcher's for the whole task
COLLECTIVE_S, LAUNCH_S = 60, 240


def launch(task: str, world: int, out: Path, timeout: float = LAUNCH_S) -> list:
    """Run ``task`` on ``world`` ranks; returns each rank's output, raises
    with every rank's output if one fails or the limit passes."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, __file__, task, str(r), str(world), str(out)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    logs, failed = [], False
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                failed = True
                break
            failed |= p.returncode != 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if failed:
        raise RuntimeError(f"{task} on {world} ranks failed or passed {timeout} s:\n"
                           + "\n".join(f"--- rank {i}\n{t}" for i, t in enumerate(logs)))
    return logs


# --------------------------------------------------------------------------- #
# rank side
# --------------------------------------------------------------------------- #
def _flags(capacity_factor=4.0):
    import torch
    from repro_torch.models import RuntimeFlags

    return RuntimeFlags(dense_attn_max=16, kv_chunk=8, moe_capacity_factor=capacity_factor,
                        compute_dtype=torch.float32)


def _np(x):
    return x.detach().float().numpy() if x.dtype.is_floating_point else x.numpy()


def _save(out: Path, name: str, rank: int, x) -> None:
    import numpy as np

    np.save(out / f"{name}.r{rank}.npy", _np(x) if hasattr(x, "detach") else np.asarray(x))


def _digest(flat: dict) -> str:
    """sha256 of the leaves' bytes, in key order."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode())
        h.update(flat[k].detach().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _shardings(mesh, out: Path) -> dict:
    """``{leaf key: NamedSharding}`` on ``mesh`` of the test's state, from
    the specs it wrote (``state_specs.json``)."""
    from repro_torch.parallel.sharding import NamedSharding, PartitionSpec

    specs = json.loads((out / "state_specs.json").read_text())
    return {k: NamedSharding(mesh, PartitionSpec(*(tuple(a) if isinstance(a, list) else a
                                                   for a in v)))
            for k, v in specs.items()}


def _parallel(rank: int, world: int, out: Path) -> None:
    """2 x 2 (data, model): sharded loss, gradients and prefill; ZeRO-1
    train steps; the per-group capacity; the int8 all-reduce on 2 and 4
    ranks; the sharded save."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.checkpoint.store import flatten_with_keys
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.launch.steps import (
        build_model, build_prefill_step, build_train_step, moment_shardings,
        param_shardings, sharded_value_and_grad,
    )
    from repro_torch.models import moe as PM
    from repro_torch.optim import AdamWState, adamw_init, dp_allreduce_int8
    from repro_torch.parallel.sharding import (
        NamedSharding, PartitionSpec, gather_tree, local_block, shard_tree, spec_axes,
    )

    mesh = make_mesh_compat((2, 2), ("data", "model"), device="cpu")
    mesh4 = make_mesh_compat((4,), ("data",), device="cpu")
    d = mesh.axis_rank("data")
    res: dict = {}

    def rows(x, on=mesh):
        return local_block(x, NamedSharding(on, PartitionSpec("data")))

    # ---- sharded loss, gradients, prefill --------------------------------- #
    for name in LOSS_NAMES:
        cfg = configs.get(name).reduced()
        model = build_model(cfg, _flags(), mesh)
        params = torch.load(out / f"params.{name}.pt")
        p_sh = param_shardings(model)
        mine = shard_tree(params, p_sh)
        toks = torch.from_numpy(np.load(out / f"tokens.{name}.npy"))
        loss, metrics, grads = sharded_value_and_grad(model, mine, {"tokens": rows(toks)})
        res[name] = {"loss": float(loss), "ce": float(metrics["ce"]),
                     "aux": float(metrics["aux"])}
        flat_sh = flatten_with_keys(p_sh)
        full = gather_tree({k: grads[k] for k in flat_sh}, flat_sh)
        if rank == 0:
            torch.save(full, out / f"grads.{name}.pt")
        logits, _ = build_prefill_step(model, S + 8)(mine, {"tokens": rows(toks)})
        _save(out, f"prefill.{name}", rank, logits[:, -1])

    for where, name, mode in REGIMES:
        on = mesh if where == "2x2" else mesh4
        model = build_model(configs.get(name).reduced(), _flags(), on, rules_mode=mode)
        params = torch.load(out / f"params.{name}.pt")
        flat_sh = flatten_with_keys(param_shardings(model))
        toks = torch.from_numpy(np.load(out / f"tokens.{name}.npy"))
        loss, _, grads = sharded_value_and_grad(model, shard_tree(params, flat_sh),
                                                {"tokens": rows(toks, on)})
        res[f"{where}.{name}.{mode}"] = float(loss)
        full = gather_tree({k: grads[k] for k in flat_sh}, flat_sh)
        if rank == 0:
            torch.save(full, out / f"grads.{where}.{name}.{mode}.pt")

    # ---- the per-group capacity: the config's capacity factor ------------ #
    cfg = configs.get("qwen3-moe-30b-a3b").reduced()
    model = build_model(cfg, _flags(None), mesh)
    params = torch.load(out / "params.qwen3-moe-30b-a3b.pt")
    drops, route = [], PM.route

    def tap(*a, **kw):
        r = route(*a, **kw)
        drops.append(int((~r.keep).sum()))
        return r

    PM.route = tap
    try:
        model.loss_fn(shard_tree(params, param_shardings(model)),
                      {"tokens": rows(torch.from_numpy(
                          np.load(out / "tokens.qwen3-moe-30b-a3b.npy")))})
    finally:
        PM.route = route
    res["drops"] = drops

    # ---- two ZeRO-1 train steps, f32 and int8 moments --------------------- #
    for name in TRAIN_NAMES:
        cfg = configs.get(name).reduced()
        for quant in (False, True):
            tag = f"{name}.{'int8' if quant else 'f32'}"
            model = build_model(cfg, _flags(), mesh)
            params = torch.load(out / f"params.{name}.pt")
            p_sh, m_sh = param_shardings(model), moment_shardings(model, quant)
            o_sh = AdamWState(step=NamedSharding(mesh, PartitionSpec()), moments=m_sh)
            p = shard_tree(params, p_sh)
            o = shard_tree(adamw_init(params, quantize=quant), o_sh)
            step = build_train_step(model, lr=LR, total_steps=TOTAL)
            losses = []
            for i in range(2):
                toks = torch.from_numpy(np.load(out / f"tokens.{name}.{i}.npy"))
                p, o, m = step(p, o, {"tokens": rows(toks)})
                losses.append(float(m["loss"]))
            res[tag] = {"losses": losses, "grad_norm": float(m["grad_norm"])}
            # replicated leaves and their moments, hashed for the model ranks
            flat_sh = flatten_with_keys(p_sh)
            rep = {k: v for k, v in flatten_with_keys(p).items()
                   if "model" not in spec_axes(flat_sh[k].spec)}
            mom = {k: v for k, v in flatten_with_keys(o.moments).items()
                   if k.rpartition("/")[0] in rep}
            res[tag]["replicated_digest"] = _digest({**rep, **mom})
            full_p = gather_tree(p, p_sh)
            full_o = gather_tree(o, o_sh)
            if rank == 0:
                torch.save({"params": full_p, "opt": full_o}, out / f"trained.{tag}.pt")

    # ---- dp_allreduce_int8 on the data axis (2 ranks) and on 4 ranks ----- #
    x = torch.from_numpy(np.load(out / f"allreduce_in.r{rank}.npy"))
    _save(out, "allreduce2", rank, dp_allreduce_int8(x, mesh, "data"))
    _save(out, "allreduce4", rank, dp_allreduce_int8(x, mesh4, "data"))

    # ---- the sharded save ------------------------------------------------- #
    sh = _shardings(mesh, out)
    blocks = shard_tree(torch.load(out / "state.pt", weights_only=False), sh)  # written by the test
    for codec in CODECS:
        CheckpointStore(str(out / f"ckpt_{codec}"), codec).save(3, blocks, shardings=sh)
    res["data_rank"] = d
    (out / f"result.r{rank}.json").write_text(json.dumps(res))
    dist.barrier()


def _restore(rank: int, world: int, out: Path) -> None:
    """1 x 2 (data, model): the 2 x 2 checkpoint restored onto it."""
    import torch

    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.launch.mesh import make_mesh_compat

    mesh = make_mesh_compat((1, 2), ("data", "model"), device="cpu")
    sh = _shardings(mesh, out)
    for codec in CODECS:
        got = CheckpointStore(str(out / f"ckpt_{codec}"), codec).restore(
            3, device="cpu", shardings=sh)
        torch.save(got, out / f"restored_1x2.{codec}.r{rank}.pt")


def _pipeline(rank: int, world: int, out: Path) -> None:
    """A 4-stage GPipe pipeline: output and the stage weights' gradient."""
    import numpy as np
    import torch

    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.parallel.pp import pipeline_apply
    from repro_torch.parallel.sharding import NamedSharding, PartitionSpec, shard_tree

    mesh = make_mesh_compat((world,), ("stage",), device="cpu")
    w = torch.from_numpy(np.load(out / "pp_w.npy"))
    x = torch.from_numpy(np.load(out / "pp_x.npy"))
    mine = shard_tree({"w": w}, NamedSharding(mesh, PartitionSpec("stage")))
    mine = {"w": mine["w"].clone().requires_grad_(True)}

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"])

    o = pipeline_apply(stage_fn, mine, x, mesh, axis="stage")
    (gw,) = torch.autograd.grad((o * o).sum(), [mine["w"]])
    _save(out, "pp_out", rank, o)
    _save(out, "pp_grad", rank, gw)


TASKS = {"parallel": _parallel, "restore": _restore, "pipeline": _pipeline}


def main() -> int:
    task, rank, world, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/rdzv_{task}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=COLLECTIVE_S))
    try:
        TASKS[task](rank, world, out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
