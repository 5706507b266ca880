"""A/B timing of the recurrent scan kernels, the two backwards and the
selective-scan forward, for two or more checkouts of the port.

    python3 tools/bwd_ab.py A_ROOT B_ROOT [C_ROOT ...] [--order abba] [--what fwd,bwd]
                            [--fwd-variant 'OLD=>NEW' ...]

For each letter of ``--order`` (``a``: A_ROOT, ``b``: B_ROOT, ...), one
process with that checkout's ``src`` on the path and its libraries built
from that checkout's sources runs what ``--what`` names (both by default).

``bwd``: ``rwkv6_bwd`` and ``mamba_scan_bwd`` at the training shapes of
``chip_smoke.py`` phase 49 (RWKV6-7B: B 8, S 1024, 64 heads of 64;
Jamba-1.5-Large: B 8, S 1024, d_inner 16384, d_state 16; zero initial
state, inputs from phase 49's seed):

* the whole call, ``wkv6_bwd`` / ``selective_scan_bwd``: device ms (a CUDA
  graph of the call, median of 10 replays);
* its device kernels, from a ``torch.profiler`` trace of ten calls: ms a
  launch, grid, block, registers a thread, shared memory a block, the
  trace's estimated occupancy and the resident warps an SM those allow;
* the bytes the call allocates beyond its outputs (the scratch), from
  ``torch.cuda.max_memory_allocated``;
* ``ptxas``'s registers and spills of each kernel of the two libraries;
* a sha256 of the outputs' bits, to compare runs of one checkout, and of
  ds0 / dh0 on a case with an initial state and a final state's gradient
  (B 2, S 100, 8 heads / 2048 channels), which must agree across
  checkouts.

``fwd``: ``mamba_scan`` (``selective_scan``) at ``chip_smoke.py`` phase
45's timed shapes (Jamba-1.5-Large: B 8, d_inner 16384, d_state 16):

* a prefill launch, S 1024 from a zero state (phase 45's seed 80), and a
  decode step's 7 launches, each on its own layer's state (seeds 90-96):
  device ms a launch (a CUDA graph, median of 100 replays);
* each call's device kernels, as above;
* ``ptxas``'s registers and spills, and the SASS of each forward kernel
  by kind (``cuobjdump``; per MUFU.EX2, i.e. per state-entry update, since
  every update takes exactly one): the expf's other instructions cannot be
  told from the rest, so the kinds are MUFU, FMUL, FADD, FFMA, shared
  loads, global loads and cp.async, shuffles, stores, other;
* the final states held bit for bit to the plain version's and y within
  ``chip_smoke.SCAN_Y_TOL`` of it (the run fails otherwise), and sha256s
  of the final states, which must agree across checkouts (y's may not: a
  redesign may change its summation order).

``--fwd-variant 'OLD=>NEW'`` (repeatable) adds a checkout after the given
ones: a copy of the last root's ``src`` under ``build/ab_variants/`` whose
``csrc/mamba_scan.cu`` has the one line holding OLD replaced by NEW, for
timing a design choice (e.g. ``'kPrefillWarps = 32;=>kPrefillWarps =
48;'``); it takes the next letter.

Needs one CUDA card and ``chip_smoke.py`` beside ``tools/`` (its input and
timing helpers).  Prints the card's name and power limit, then one JSON
line a run.  Unpack the other checkout with ``git archive`` into a
directory that ``.gitignore`` lists (e.g. ``build/ab_parent``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: the forward's kernels in the first design and in the redesign
FWD_PATTERN = r"(selective_scan_kernel|scan_prefill_kernel|scan_decode_kernel)"
#: SASS opcodes by kind
SASS_KINDS = (("mufu", ("MUFU",)), ("fmul", ("FMUL",)), ("fadd", ("FADD",)),
              ("ffma", ("FFMA",)), ("shared_load", ("LDS",)),
              ("global_load", ("LDG", "LDGSTS", "LDGDEPBAR", "LD")),
              ("shuffle", ("SHFL",)), ("store", ("STG", "STS", "ST")))


def resident_warps(rec: dict):
    """Warps an H100 SM holds of a kernel with the trace's block, registers
    a thread and shared memory a block (256-register allocation a warp, 1
    KB of shared memory reserved a block, 228 KB and 64 warps an SM)."""
    block, regs, smem = rec.get("block"), rec.get("registers"), rec.get("shared_bytes")
    if not block or regs is None or smem is None:
        return None
    warps = math.ceil(math.prod(block) / 32)
    by_regs = 65536 // (math.ceil(regs * 32 / 256) * 256 * warps) if regs else 32
    by_smem = 233472 // (smem + 1024)
    return min(by_regs, by_smem, 64 // warps, 32) * warps


def split(fn) -> list:
    import chip_smoke as CS

    out = CS.kernel_split(fn)
    for k in out:
        k["resident_warps_per_sm"] = resident_warps(k)
    return out


def sass_counts(lib: Path, pattern: str) -> dict:
    """Instructions of each kernel of ``lib`` whose mangled name matches
    ``pattern``, by kind: in all and per MUFU instruction (``per_mufu``),
    and per MUFU over the densest stretch of code that holds one unrolled
    chunk's updates (``chunk_per_mufu``: the fewest instructions from one
    MUFU to the one ``window`` later; a kernel that unrolls a chunk twice,
    with and without bound checks, has its checked copy left out)."""
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    return parse_sass(subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                                     text=True, check=True).stdout, pattern)


def parse_sass(text: str, pattern: str) -> dict:
    """:func:`sass_counts` on ``cuobjdump -sass`` output."""
    code, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            k = re.search(pattern + r"I((?:Li\d+E)+)E", m.group(1))
            cur = None if k is None else "{}<{}>".format(
                k.group(1), ", ".join(re.findall(r"Li(\d+)E", k.group(2))))
            if cur is not None:
                code[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T\d]\s+)?([A-Z][A-Z0-9_]*)", ln)
        if cur is not None and m is not None:
            op = m.group(1)
            code[cur].append(next((k for k, ops in SASS_KINDS if op in ops), "other"))
    out = {}
    for name, kinds in code.items():
        rec = {"all": len(kinds)}
        for k in kinds:
            rec[k] = rec.get(k, 0) + 1
        mufu = [i for i, k in enumerate(kinds) if k == "mufu"]
        if mufu:
            rec["per_mufu"] = {k: v / len(mufu) for k, v in rec.items()}
            # one chunk's updates: kChunk tokens of 4 states a thread (the
            # redesign) or of every state (the first design)
            ds = int(re.search(r"<(\d+)", name).group(1))
            window = min(len(mufu), 64 if "prefill" in name else 16 * ds)
            spans = [(mufu[i + window] if i + window < len(mufu) else len(kinds)) - mufu[i]
                     for i in range(len(mufu) - window + 1)]
            i = min(range(len(spans)), key=spans.__getitem__)
            stretch = kinds[mufu[i]:mufu[i] + spans[i]]
            rec["chunk_per_mufu"] = {"window": window, "all": len(stretch) / window,
                                     **{k: stretch.count(k) / window for k in set(stretch)}}
        out[name] = rec
    return out


def run_bwd(dev, rec: dict) -> None:
    import torch

    import chip_smoke as CS
    from repro_torch.configs import get
    from repro_torch.kernels import build
    from repro_torch.kernels import mamba as MB
    from repro_torch.kernels import rwkv6 as RW

    logs = build._build_missing(["rwkv6_bwd", "mamba_scan_bwd"])
    rec["ptxas"] = {**CS.ptxas_kernels(logs.get("rwkv6_bwd", ""), r"(wkv6_bwd_\w+_kernel)"),
                    **CS.ptxas_kernels(logs.get("mamba_scan_bwd", ""), r"(scan_bwd_\w+_kernel)")}
    rwkv, jamba = get(CS.RWKV), get(CS.JAMBA)
    B, S = CS.TRAIN_BATCH, CS.TRAIN_SEQ
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
                     "kernels": split(lambda x=x: fn(*x)),
                     "grads_sha256": digest, "exact_sha256": exact_digest}
        del x
        torch.cuda.empty_cache()


def run_fwd(dev, rec: dict) -> None:
    import torch

    import chip_smoke as CS
    from repro_torch.configs import get
    from repro_torch.kernels import build
    from repro_torch.kernels import mamba as MB
    from repro_torch.kernels import ops

    logs = build._build_missing(["mamba_scan"])
    rec["fwd_ptxas"] = CS.ptxas_kernels(logs.get("mamba_scan", ""), FWD_PATTERN)
    rec["fwd_sass"] = sass_counts(build._lib_path("mamba_scan"), FWD_PATTERN)
    jamba = get(CS.JAMBA)
    B, S, din, ds = CS.REQUESTS, CS.PROMPT_LEN, jamba.d_inner, jamba.ssm.d_state
    n_mamba = sum(s.mixer == "mamba" for s in jamba.pattern)
    emulate = getattr(MB, "selective_scan_kernel_order", None)

    x = MB.sample_scan_inputs(B, S, din, ds, seed=80, device=dev, with_h0=False)
    n0 = MB.selective_scan.launches
    y, h = ops.selective_scan(*x)
    launches = MB.selective_scan.launches - n0
    y_err = CS.scan_close((y, h), MB.selective_scan_ref(*x), "prefill against the plain version")
    emu = None if emulate is None else CS.same_bits(y, emulate(*x)[0])
    rec["prefill"] = {"shape": [B, S, din, ds], "launches_a_call": launches,
                      "state_sha256": CS.bits_digest([h]), "y_sha256": CS.bits_digest([y]),
                      "y_max_abs_err": y_err, "y_max_abs": float(y.abs().max()),
                      "y_bit_equal_to_kernel_order": emu}
    del y, h
    rec["prefill"]["repeat_bit_equal"] = CS.bits_digest(ops.selective_scan(*x)) == \
        CS.bits_digest(ops.selective_scan(*x))
    rec["prefill"]["ms"], _ = CS.device_ms([lambda: ops.selective_scan(*x)], samples=100)
    rec["prefill"]["kernels"] = split(lambda: ops.selective_scan(*x))
    del x
    torch.cuda.empty_cache()

    layers = [MB.sample_scan_inputs(B, 1, din, ds, seed=90 + i, device=dev)
              for i in range(n_mamba)]
    outs = [torch.empty_like(v[5]) for v in layers]
    ys = [ops.selective_scan(*v, state_out=o)[0] for v, o in zip(layers, outs)]
    errs = [CS.scan_close((yv, o), MB.selective_scan_ref(*v), f"decode layer {i}")
            for i, (v, o, yv) in enumerate(zip(layers, outs, ys))]
    emu = None if emulate is None else all(
        CS.same_bits(yv, emulate(*v)[0]) for v, yv in zip(layers, ys))
    in_place = layers[0][5].clone()
    ops.selective_scan(*layers[0][:5], in_place, state_out=in_place)
    rec["decode"] = {"shape": [B, 1, din, ds], "layers": n_mamba,
                     "state_sha256": CS.bits_digest(outs), "y_sha256": CS.bits_digest(ys),
                     "in_place_bit_equal": CS.same_bits(in_place, outs[0]),
                     "y_max_abs_err": max(errs), "y_bit_equal_to_kernel_order": emu}
    calls = [lambda v=v, o=o: ops.selective_scan(*v, state_out=o) for v, o in zip(layers, outs)]
    rec["decode"]["ms"], _ = CS.device_ms(calls, samples=100)
    rec["decode"]["kernels"] = split(lambda: [c() for c in calls])
    del layers, outs, ys
    torch.cuda.empty_cache()


def run(root: str, what: list) -> None:
    """One checkout's timings (this process's ``src`` is ``root``'s)."""
    import torch

    sys.path.insert(1, str(ROOT))  # chip_smoke's helpers
    dev = torch.device("cuda", 0)
    rec = {"root": root}
    if "fwd" in what:
        run_fwd(dev, rec)
    if "bwd" in what:
        run_bwd(dev, rec)
    print(json.dumps(rec), flush=True)


def make_variant(base: str, subs: str, i: int) -> str:
    """A copy of ``base``'s ``src`` whose ``csrc/mamba_scan.cu`` has the one
    line holding OLD replaced by NEW (``subs`` is ``OLD=>NEW``)."""
    old, new = subs.split("=>", 1)
    root = ROOT / "build" / "ab_variants" / f"v{i}"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(Path(base) / "src", root / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = root / "src" / "repro_torch" / "kernels" / "csrc" / "mamba_scan.cu"
    text = cu.read_text()
    if text.count(old) != 1:
        raise SystemExit(f"bwd_ab: {old!r} is not in {cu} exactly once")
    cu.write_text(text.replace(old, new))
    return str(root)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--order", default="abba")
    ap.add_argument("--what", default="fwd,bwd")
    ap.add_argument("--fwd-variant", action="append", default=[])
    ap.add_argument("--run", help=argparse.SUPPRESS)
    a = ap.parse_args()
    what = a.what.split(",")
    if a.run:
        sys.path.insert(0, str(Path(a.run).resolve() / "src"))
        run(a.run, what)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    roots = list(a.roots)
    for i, subs in enumerate(a.fwd_variant):
        roots.append(make_variant(a.roots[-1], subs, i))
        print(json.dumps({"letter": chr(ord("a") + len(roots) - 1), "root": roots[-1],
                          "variant": subs}), flush=True)
    letters = {chr(ord("a") + i): r for i, r in enumerate(roots)}
    me = str(Path(__file__).resolve())
    for letter in a.order:
        subprocess.run([sys.executable, me, "--run", letters[letter], "--what", a.what],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
