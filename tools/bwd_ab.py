"""A/B timing of the two recurrent backward kernels for two checkouts of
the port.

    python3 tools/bwd_ab.py A_ROOT B_ROOT [--order abba]

For each letter of ``--order`` (``a``: A_ROOT, ``b``: B_ROOT), one process
with that checkout's ``src`` on the path and its ``rwkv6_bwd`` and
``mamba_scan_bwd`` libraries built from that checkout's sources runs, at
the training shapes of ``chip_smoke.py`` phase 49 (RWKV6-7B: B 8, S 1024,
64 heads of 64; Jamba-1.5-Large: B 8, S 1024, d_inner 16384, d_state 16;
zero initial state, inputs from phase 49's seed):

* the whole call, ``wkv6_bwd`` / ``selective_scan_bwd``: device ms (a CUDA
  graph of the call, median of 10 replays);
* its device kernels, from a ``torch.profiler`` trace of three calls: ms
  a launch, grid, block, registers a thread, shared memory a block and the
  trace's estimated occupancy;
* the bytes the call allocates beyond its outputs (the scratch), from
  ``torch.cuda.max_memory_allocated``;
* ``ptxas``'s registers and spills of each kernel of the two libraries;
* a sha256 of the outputs' bits, to compare runs of one checkout, and of
  ds0 / dh0 on a case with an initial state and a final state's gradient
  (B 2, S 100, 8 heads / 2048 channels), which must agree across
  checkouts.

Needs one CUDA card and ``chip_smoke.py`` beside ``tools/`` (its input and
timing helpers).  Prints the card's name and power limit, then one JSON
line a run.  Unpack the other checkout with ``git archive`` into a
directory that ``.gitignore`` lists (e.g. ``build/ab_parent``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run(root: str) -> None:
    """One checkout's timings (this process's ``src`` is ``root``'s)."""
    import torch

    sys.path.insert(1, str(ROOT))  # chip_smoke's helpers
    import chip_smoke as CS
    from repro_torch.configs import get
    from repro_torch.kernels import build
    from repro_torch.kernels import mamba as MB
    from repro_torch.kernels import rwkv6 as RW

    logs = build._build_missing(["rwkv6_bwd", "mamba_scan_bwd"])
    ptxas = {**CS.ptxas_kernels(logs.get("rwkv6_bwd", ""), r"(wkv6_bwd_\w+_kernel)"),
             **CS.ptxas_kernels(logs.get("mamba_scan_bwd", ""), r"(scan_bwd_\w+_kernel)")}
    dev = torch.device("cuda", 0)
    rwkv, jamba = get(CS.RWKV), get(CS.JAMBA)
    B, S = CS.TRAIN_BATCH, CS.TRAIN_SEQ
    rec = {"root": root, "ptxas": ptxas}
    for name, fn, case_fn, shape, exact in (
        ("wkv6_bwd", RW.wkv6_bwd, CS.wkv_bwd_case,
         (B, S, rwkv.rwkv_heads, rwkv.ssm.rwkv_head_dim), 5),
        ("selective_scan_bwd", MB.selective_scan_bwd, CS.scan_bwd_case,
         (B, S, jamba.d_inner, jamba.ssm.d_state), 5),
    ):
        x = case_fn(*shape, CS.BWD_SEED, dev, False, False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = fn(*x)
        torch.cuda.synchronize()
        out_bytes = sum(t.numel() * t.element_size() for t in out if t is not None)
        scratch = torch.cuda.max_memory_allocated() - before - out_bytes
        digest = CS.bits_digest(out)
        del out
        small = case_fn(2, 100, 8 if name == "wkv6_bwd" else 2048, shape[3], CS.BWD_SEED + 1,
                        dev, True, True)
        exact_digest = CS.bits_digest([fn(*small)[exact]])
        del small
        ms, _ = CS.device_ms([lambda x=x: fn(*x)])
        rec[name] = {"shape": list(shape), "ms": ms, "scratch_bytes": scratch,
                     "kernels": CS.kernel_split(lambda x=x: fn(*x)),
                     "grads_sha256": digest, "exact_sha256": exact_digest}
        del x
        torch.cuda.empty_cache()
    print(json.dumps(rec), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("a_root", nargs="?")
    ap.add_argument("b_root", nargs="?")
    ap.add_argument("--order", default="abba")
    ap.add_argument("--run", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.run:
        sys.path.insert(0, str(Path(a.run).resolve() / "src"))
        run(a.run)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    roots = {"a": a.a_root, "b": a.b_root}
    me = str(Path(__file__).resolve())
    for letter in a.order:
        subprocess.run([sys.executable, me, "--run", roots[letter]], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
