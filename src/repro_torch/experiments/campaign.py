"""CLI for resumable paper-grid campaigns, the port's copy of the
reference's ``repro/experiments/campaign.py``.

Launch (on the CUDA card unless ``--device`` names another device)::

    python -m repro_torch.experiments.campaign --preset validation \
        --ckpt-dir /scratch/camp --chunk-lanes 2700 --out sweep.json

Kill it at any point (SIGKILL included) and resume with nothing but the
checkpoint directory — the launch parameters are persisted alongside the
snapshots, and the resumed run's results are bit-identical to an
uninterrupted one::

    python -m repro_torch.experiments.campaign --resume /scratch/camp --out sweep.json

``--device`` is not persisted either: a resume may run on another device
(results are device-count invariant), e.g. ``--device cpu`` to finish a
campaign on the host.  The ``--chaos-*`` flags arm a deterministic
:class:`~repro_torch.ft.injection.ChaosInjector` (chunk-boundary kills /
OOMs / device losses) for tests; chaos configuration is deliberately
*not* persisted, so a resume is always chaos-free unless re-armed
explicitly.  ``--chaos-torch-fail-at`` is the reference's
``--chaos-jax-fail-at``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from ..core.engine import EngineConfig
from ..ft.campaign import CampaignConfig, CampaignRunner
from ..ft.injection import ChaosInjector
from .grid import GridSpec
from .paper_grid import paper_grid_cells

__all__ = ["main"]

#: launch-parameter sidecar living next to the snapshots
_PARAMS_FILE = "campaign_cli.json"


def _int_list(text: str) -> List[int]:
    return [int(t) for t in text.split(",") if t.strip() != ""]


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.experiments.campaign",
        description="killable/resumable fused paper-grid sweep",
    )
    ap.add_argument("--preset", default="validation",
                    choices=("validation", "bench", "full"))
    ap.add_argument("--limit-cells", type=int, default=None,
                    help="truncate the preset's cell list (smoke tests)")
    ap.add_argument("--n-runs", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-mode", default="device",
                    choices=("device", "host"))
    ap.add_argument("--collect", default="stats", choices=("stats", "lanes"))
    ap.add_argument("--chunk-lanes", default="auto",
                    help="lanes per chunk (int) or 'auto'")
    ap.add_argument("--ckpt-dir", default=None,
                    help="snapshot directory (required unless --resume)")
    ap.add_argument("--resume", default=None, metavar="DIR",
                    help="resume the campaign whose snapshots live in DIR")
    ap.add_argument("--ckpt-period", type=float, default=None,
                    help="snapshot period seconds; 0 = every chunk; "
                         "default lets optimize('young') choose")
    ap.add_argument("--mtbf", type=float, default=3600.0,
                    help="assumed MTBF of the machine running the sweep")
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--sync-snapshots", action="store_true",
                    help="block on disk drain (default: async)")
    ap.add_argument("--out", default=None, help="write SweepResult JSON")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    chaos = ap.add_argument_group("chaos injection (tests)")
    chaos.add_argument("--chaos-seed", type=int, default=0)
    chaos.add_argument("--chaos-p-kill", type=float, default=0.0)
    chaos.add_argument("--chaos-p-oom", type=float, default=0.0)
    chaos.add_argument("--chaos-p-device-loss", type=float, default=0.0)
    chaos.add_argument("--chaos-kill-at", type=_int_list, default=[])
    chaos.add_argument("--chaos-oom-at", type=_int_list, default=[])
    chaos.add_argument("--chaos-device-loss-at", type=_int_list, default=[])
    chaos.add_argument("--chaos-torch-fail-at", type=int, default=None)
    chaos.add_argument("--chaos-kill-mode", default="raise",
                       choices=("raise", "sigkill"))
    chaos.add_argument("--chaos-max-fires", type=int, default=None)
    return ap


def _chaos_from(args) -> Optional[ChaosInjector]:
    armed = (
        args.chaos_p_kill or args.chaos_p_oom or args.chaos_p_device_loss
        or args.chaos_kill_at or args.chaos_oom_at
        or args.chaos_device_loss_at or args.chaos_torch_fail_at is not None
    )
    if not armed:
        return None
    return ChaosInjector(
        seed=args.chaos_seed,
        p_kill=args.chaos_p_kill,
        p_oom=args.chaos_p_oom,
        p_device_loss=args.chaos_p_device_loss,
        kill_at=tuple(args.chaos_kill_at),
        oom_at=tuple(args.chaos_oom_at),
        device_loss_at=tuple(args.chaos_device_loss_at),
        torch_fail_at=args.chaos_torch_fail_at,
        kill_mode=args.chaos_kill_mode,
        max_fires=args.chaos_max_fires,
    )


def _grid_params(args) -> dict:
    return {
        "preset": args.preset,
        "limit_cells": args.limit_cells,
        "n_runs": args.n_runs,
        "seed": args.seed,
        "trace_mode": args.trace_mode,
        "collect": args.collect,
        "chunk_lanes": args.chunk_lanes,
        "mtbf": args.mtbf,
        "ckpt_period": args.ckpt_period,
        "keep": args.keep,
    }


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    resume: object = "auto"
    if args.resume is not None:
        ckpt_dir = args.resume
        path = os.path.join(ckpt_dir, _PARAMS_FILE)
        if not os.path.exists(path):
            print(f"no {_PARAMS_FILE} in {ckpt_dir}; nothing to resume",
                  file=sys.stderr)
            return 2
        with open(path) as f:
            params = json.load(f)
        resume = "auto"  # finished campaigns re-emit from the final snapshot
    else:
        if args.ckpt_dir is None:
            print("--ckpt-dir is required unless --resume", file=sys.stderr)
            return 2
        ckpt_dir = args.ckpt_dir
        params = _grid_params(args)
        os.makedirs(ckpt_dir, exist_ok=True)
        with open(os.path.join(ckpt_dir, _PARAMS_FILE), "w") as f:
            json.dump(params, f, indent=1)

    cells = paper_grid_cells(params["preset"])
    if params.get("limit_cells"):
        cells = cells[: params["limit_cells"]]
    grid = GridSpec(cells=tuple(cells), n_runs=params["n_runs"],
                    seed=params["seed"])
    chunk = params["chunk_lanes"]
    cfg = EngineConfig(
        engine="torch",
        trace_mode=params["trace_mode"],
        collect=params["collect"],
        chunk_lanes="auto" if chunk == "auto" else int(chunk),
    )
    camp = CampaignConfig(
        ckpt_dir=ckpt_dir,
        mtbf=params["mtbf"],
        ckpt_period=params["ckpt_period"],
        keep=params["keep"],
        async_snapshots=not args.sync_snapshots,
        chaos=_chaos_from(args),
    )
    res = CampaignRunner(grid, camp, cfg, device=args.device).run(resume=resume)
    info = res.meta["campaign"]
    print(
        f"campaign done: {len(res.cells)} cells, {grid.n_lanes} lanes, "
        f"engine {res.engine}, incarnation {info['incarnation']}, "
        f"{info['n_snapshots']} snapshots, wall {res.wall_time_s:.1f}s"
    )
    if args.out:
        res.write_json(args.out)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
