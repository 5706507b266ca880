#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` into
``build/repro_torch/``, holds each kernel against its plain PyTorch
version on the card (the cursor walks on the main path's own lanes: the
arguments of one outer iteration's walks, captured from a short run of
the grid), drives the main path — the full paper grid (108 cells, 1000
Monte-Carlo runs each) through ``repro_torch.experiments.run_grid`` on
CUDA — checks that the sim_step kernels ran on it, with its outer
iterations unchanged and at most one host sync and four cursor launches
an iteration, checks the card's results against the port's CPU path on
the validation grid, and times each kernel (phases 1-6).

Then the checkpoint path (phases 7-10): the int8 / int8-delta codec
kernels against their plain versions on edge-case leaves and on
SmolLM-135M's 1.61 GB training state (params and AdamW moments), the
card's payloads against the host codec; saves of that state through
``repro_torch.checkpoint`` (raw, int8, int8_delta: a blocking save, an
async save and ``restore_latest`` onto the card each, checked against the
codec's error bound, with 30 kernel launches a codec save or restore),
a buddy save and restore after node loss; and the codec kernels' times.

Then the serving path of SmolLM-135M (phases 11-14): the two attention
kernels (``flash_attention_bhsd``: the tensor-core kernel on bf16, the f32
one on f32, each case's variant checked; ``decode_attention_bhd``: split
and combine kernels, at pos -1, a split's edges and beyond) against their
plain versions at the path's shapes, in bf16 and f32; the model on the
card against the port on the CPU (full width, 2 layers, f32); the path
itself, ``repro_torch.launch.serve`` at full width and depth (8 requests
of 1024 prompt tokens, 128 generated), once without faults and once with
wall-clock faults, whose tokens must equal the fault-free ones, with 30
flash launches a prefill (all on the tensor-core kernel) and 30 decode
calls a decode step, and a dense-attention run held to the kernel run;
and the kernels' times beside their bounds, plain versions and
``scaled_dot_product_attention`` (and the device kernels of one decode
call, counted in a profiler trace).

Then the serving path of RWKV6-7B (phases 15-18): the WKV6 kernel
(``wkv6_bhsd``) against its plain version at the path's prefill and
decode shapes and on edge cases (final state bit-equal, y within a stated
tolerance); the RWKV model on the card against the port on the CPU (full
width, 2 layers, f32); ``repro_torch.launch.serve`` on ``rwkv6-7b`` at
full width and depth in bf16 (8 requests of 1024 prompt tokens, 128
generated), once without faults and once with wall-clock faults, whose
tokens must equal the fault-free ones, with 32 kernel launches a prefill
and 32 a decode step, one decode step replayed as a CUDA graph against
the same step issued eagerly; and the kernel's times at both shapes, at
its default tile and at the other built one, beside its bound, its f32
issue floor (at the SM clock read during the timing), its launch floor
and its plain version.

Then the mixed-law sweep (phases 19-21): the law-indexed variant of the
sim_step kernels against its plain version and, on each law's lanes,
against the single-law launch (0 ulp); the reference benchmark's
mixed-law grid (the bench grid under the exponential, Weibull 0.7 and
lognormal 0.5 laws: 216 cells, 1000 runs each) in one dispatch through
``run_grid`` on CUDA, with only the law-indexed kernels launched; the
card against the CPU, and the fused dispatch against the per-family one
lane for lane, on the three-law validation grid; and the variant's times.

Then the paper's Section 5 check (phases 22-23): the batched Newton solve
of every cell's optimal period in f64 on the card, on the full grid's
table, against the same solve on the CPU, the host scan of the period
grid and the closed-form extremizer, and timed on a 65,536-cell table
(with no host sync inside the solve); then the Holm-controlled
equivalence tests of the simulated waste against the analytic models, on
the validation grid at 200 runs a cell and on the main path's own sweep
of phase 4, which must reject no cell.

Then the lane machine's other modes (phases 24-25): the silent walk
(single-law and law-indexed) against its plain version on the scenario
sweep's own lanes, the prediction walk with trust coins against its plain
version (both variants, both modes) on sampled lanes of trust 0, 0.3,
0.5 and 1, and no silent-walk launch on the main path; then the scenario
grid (two-level checkpoints and silent errors: 48 cells, 1000 runs each)
through ``run_grid`` on CUDA, its validation gate (24 cells at 200 runs:
the card's bits equal to the CPU's, disk recoveries and detections
included, 0 Holm rejects, detections in every silent cell), the same
cells under two laws in one dispatch against the per-family one, and the
paper grid with fractional trust (q 0.3 / 0.5) on the card against the
CPU.

Then the host trace mode (phases 26-29): the trace-fed primitive update
(no stream, the counterpart of the reference's ``_step_kernel``) against
its plain version on 108,000 sampled lanes, and the three slab walks
(the prediction skip, the stale-fault cascade with the migration cancel,
the silent strikes) against theirs on iteration 40 of the host-mode full
grid and scenario grid, every output bit-equal; the full paper grid with
host-drawn traces (``run_grid(trace_mode="host")``, 108 cells × 1000
runs: the wall split into host generation, packing, copy and lane loop,
the slabs' shapes and bytes, one launch of each kernel an iteration, the
validation gate with the CPU port's z beside the largest and any
rejected cell) and the scenario grid in host mode (the silent slab walk's
path); a 12-cell sub-grid card against CPU and fused against per-cell in
both trace modes; the paper's Tables 1-2 grid (120 cells, with Weibull
0.5 superposed fresh-start traces, plus a stationary family) through
``run_cells`` (its 120 cells from ``repro_torch.paper.sim_tables.
build_cells``); and the four kernels' times.

Then the engine API (phases 30-33, no kernel of their own): the 12-cell
sub-grid through ``run_grid(grid, EngineConfig(...))`` in both trace
modes, bit for bit the keyword call, and its lanes against the NumPy
engine and the scalar engine on the same traces; ``devices=`` as None,
1, "all" and the card named twice, lane for lane; BestPeriod
(``optimize(method="search")``, seven families, 100 runs at N = 2^19) on
the card against the NumPy engine, with each call's iterations, host
syncs and launches; the paper's drivers (``repro_torch.paper``) on the
card against the NumPy engine.

Every phase prints one JSON line; any failure exits non-zero before the
last line, which is ``{"ok": true, "device": {...}}``.  Needs one CUDA
card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM data-sheet peaks the bound is taken against
PEAK_BYTES_S = 3.35e12  # HBM3
PEAK_F64_S = 34e12  # FP64, outside the tensor cores
PEAK_F32_S = 67e12  # FP32, outside the tensor cores

#: bytes the kernels must move on given data: every input a lane needs
#: read once, every output it changes written once.  Primitive update:
#: 80 B read (prim, cont 4 B; target, ckend, nf, t, saved, unsaved, pw, W,
#: DR 8 B) and 36 B written (t, saved, unsaved, pw; flags) per lane, and a
#: lane that faulted also reads its stream (key, ctr, mean, horizon: 28 B)
#: and writes the refilled cursor (ctr, tm: 12 B).  Stream advance: the
#: 1 B mask per lane; a masked lane reads ctr, tm, key, mean, horizon
#: (36 B) and writes ctr, tm (12 B).
BYTES_PRIM, BYTES_PRIM_FAULTED = 116, 40
BYTES_ADV, BYTES_ADV_MASKED = 1, 48
#: the law-indexed variants: a lane that draws (faulted, or masked) also
#: reads its law code (4 B) and shape slots s1, s2 (8 B each)
BYTES_LAW = 20
#: f64 operations, approximate: ~20 adds / compares / selects per lane of
#: the update, ~40 for one gap draw (uniform, log1p, scale, add, retire)
OPS_PRIM, OPS_GAP = 20, 40
#: the walks' bytes on given data: a walk reads what decides whether a lane
#: walks, then the record of the lanes that walk (their counters moved),
#: and writes those lanes' outputs once, however many events they draw.
#: Skip walk (prediction walk with the clock): the mask (1 B) on every
#: lane; t, lead_act, tp_t0, fp_time (32 B) on masked lanes; a walking
#: lane reads la_ctr, tp_ctr, fp_ctr (4 B), la_time, tp_ft, three keys,
#: f_mean, fp_mean, recall, window, horizon (8 B) = 92 B and writes the
#: seven cursors (44 B).  Refill (pop and priming): both masks (2 B) on
#: every lane; a walking lane reads 92 B plus tp_t0, fp_time and writes
#: 44 B.  Strike walk: res (1 B); t, sf_time, sf_ctr (20 B) and, with
#: migration, three cancel slots (12 B) on the lanes of res; a walking lane
#: reads DR, key, mean, horizon, n_faults (40 B) and writes t, sf_ctr,
#: sf_time, n_faults (28 B).
BYTES_SKIP_MASK, BYTES_SKIP_HEAD, BYTES_SKIP_WALK = 1, 32, 92 + 44
BYTES_REFILL_MASK, BYTES_REFILL_WALK = 2, 92 + 16 + 44
BYTES_STRIKE_MASK, BYTES_STRIKE_HEAD, BYTES_CANCELS, BYTES_STRIKE_WALK = 1, 20, 12, 40 + 28
#: the prediction walk with trust coins: a walking lane also reads its two
#: trust keys and q (24 B).  Silent walk: silr (1 B); t, sf_time (16 B) on
#: the lanes of silr; a walking lane reads sf_ctr, corrupt, key, mean,
#: horizon (36 B) and writes sf_ctr, sf_time, corrupt (20 B)
BYTES_TRUST = 24
BYTES_SILENT_MASK, BYTES_SILENT_HEAD, BYTES_SILENT_WALK = 1, 16, 36 + 20
#: the walk kernels' wrappers (the silent walk runs on silent-error lanes
#: only), and all the cursor kernels'
WALKS = ("masked_prediction_walk", "masked_strike_walk")
SILENT = "masked_silent_walk"
CURSOR_KERNELS = ("masked_stream_advance",) + WALKS + (SILENT,)
#: the TPU kernel the walks loop (one event per launch there)
REPLACES_ADV = "src/repro/kernels/sim_step.py:409"
#: the outer iteration whose walks phases 3, 6, 19 and indexed_timing replay
CAPTURE_ITER = 40
#: outer iterations of the full and the mixed-law grid with the one-event
#: cursor loops: each lane draws the same events in the same order in the
#: walks, so these must not move
OUTER_ITERS = {"full": 1168, "mixed": 1240}
#: the card's L2; timed calls cycle through input copies three times larger
L2_BYTES = 50e6
RUNS_PER_CELL = 1000
#: the mixed-law path's seed, the reference benchmark's
MIXED_SEED = 5
#: phase 22: card vs CPU tolerance of the Newton solve, the most its waste
#: may exceed the host period scan's best (the reference's
#: newton_excess_waste_max gate), the tolerance against the closed-form
#: extremizer on the smooth families, and the timed table's size and seed
NEWTON_RTOL, NEWTON_EXCESS_MAX, EXTREMIZER_RTOL = 1e-12, 1e-12, 1e-9
NEWTON_CELLS, NEWTON_SEED = 65536, 3
#: phase 23: the reference validation suite's contract (runs, seed, alpha)
VALIDATION_RUNS, VALIDATION_SEED, VALIDATION_ALPHA = 200, 11, 0.01
#: phase 25: the scenario grid's seed (the reference benchmark's
#: two_level_silent_cells48 grid), the fractional trust levels, and the
#: runs a cell of the two-law fused-vs-per-family case
SCENARIO_SEED = 9
TRUST_QS = (0.3, 0.5)
SCENARIO_MIXED_RUNS = 8

TM_ULPS = 4  # refilled cursor dates: libdevice transcendentals, same on both sides
LAWS = (("exponential", 0.0), ("weibull", 0.7), ("lognormal", 1.0), ("uniform", 0.0))

#: the checkpoint path's state: SmolLM-135M's parameters and AdamW moments
#: made from this seed, and the relative perturbation between two steps
STATE_SEED = 0
DELTA_REL = 1e-3
#: f32 operations per element, approximate: quantize takes |x|, the max,
#: a divide, a round and a clip (and the delta's subtract); dequantize a
#: multiply (and the delta's add)
OPS_QUANT, OPS_DEQUANT = 5, 1
CODEC_SOURCE = "src/repro_torch/kernels/csrc/ckpt_codec.cu"
CODEC_REPLACES = {
    "quantize_blocks": "src/repro/kernels/ckpt_codec.py:44",
    "dequantize_blocks": "src/repro/kernels/ckpt_codec.py:86",
}
#: the stacked leaf that phase 8 runs through the card besides embed
STACKED_LEAF = "params/blocks/0/mlp/wi_gate"

#: the serving path: SmolLM-135M at full width and depth, weights and
#: prompts from this seed
SERVE_SEED = 0
REQUESTS, PROMPT_LEN, GEN, SNAPSHOT_EVERY = 8, 1024, 128, 16
#: faults injected in the faulted run, at most (each restore replays up to
#: SNAPSHOT_EVERY - 1 tokens, so the run ends)
MAX_FAULTS = 8
PEAK_BF16_S = 989e12  # dense bf16, tensor cores
#: the attention kernels' tolerances against their plain versions (abs and
#: rel): the reference kernel tests' own (tests/test_kernels.py:43, :77)
ATTN_TOL = {"float32": 2e-6, "bfloat16": 2e-2}
#: the model on the card against the port on the CPU, f32 compute (the
#: port-vs-reference tolerances of tests/test_torch_serve.py, measured on
#: the CPU): prefill logits; one decode step from the same cache; decode
#: steps each from its own bf16 cache, where f32 noise flips a few bf16
#: roundings of K/V
CARD_CPU_TOL = {"prefill": 1e-5, "decode_same_cache": 1e-4, "decode_own_cache": 1e-3}
#: the dense-attention serving run against the kernel run, bf16 compute at
#: 30 layers, as a fraction of max|logit| (largest difference and relative
#: L2 norm of the difference).  bf16 rounds the residual stream at other
#: places in the two paths: measured on the CPU with the plain versions
#: (B = 2, S = 256, two seeds), each bf16 path sits 1.6-2.4% (max) and
#: 1.7-2.3% (L2) from the f32 run and as far from the other; this is 2x
#: that.  (In f32 compute the two paths agreed exactly there.)
DENSE_TOL = 5e-2
ATTN_SOURCE = "src/repro_torch/kernels/csrc/{}.cu"
ATTN_REPLACES = {
    "flash_attention_bhsd": "src/repro/kernels/flash_attention.py:84",
    "decode_attention_bhd": "src/repro/kernels/decode_attention.py:65",
}

#: the RWKV6 serving path: RWKV6-7B at full width and depth, bf16 compute,
#: the same requests as the SmolLM path
WKV_SOURCE = "src/repro_torch/kernels/csrc/rwkv6.cu"
WKV_REPLACES = "src/repro/kernels/rwkv6.py:68"
#: the WKV kernel's y against its plain version's, as a fraction of
#: max|y| (an f32 emulation of the kernel's summation order on the CPU
#: measured up to 2.6e-7 on these input laws); the final state must be
#: bit-equal
WKV_Y_TOL = 1e-5
#: f32 operations per token and head of the recurrence: the state update
#: (2 products and a sum per entry), r . S (a product and a sum per
#: entry), the bonus dot r . (u * k) and c * v + y (5 per channel)
WKV_OPS_HD2, WKV_OPS_HD = 5, 5
#: f32 instructions an entry update of the exact recurrence issues at
#: least: fl(w S), fl(k v), their sum, and one FMA of r S into y
WKV_ISSUE_PER_ENTRY = 4
#: H100 SXM: SMs and f32 lanes an SM
SMS, F32_LANES = 132, 128
#: the WKV kernel's tiles at hd 64 (rows of the 4-column state tile a
#: thread owns): the defaults of a prefill and of a decode step (those of
#: ``wkv6_fwd_rows`` in csrc/rwkv6.cu), and the other built tile each is
#: timed against
WKV_TILES = {"prefill": 8, "decode": 4}
WKV_OTHER_TILE = {"prefill": 4, "decode": 8}
#: the RWKV model on the card against the port on the CPU, f32 compute,
#: full width, 2 layers.  Measured on the CPU with the port at one thread
#: against eight (another summation order, as the card's): prefill logits
#: 1.9e-5 apart, free-running decode up to 3.9e-3 (22 flipped bf16
#: roundings of ``last`` / ``cm_last`` over 8 steps); this is 5x that.
RWKV_CARD_CPU_TOL = {"prefill": 1e-4, "decode_same_cache": 1e-4, "decode_own_cache": 2e-2}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def ulp_dist(a, b):
    """Elementwise distance in units in the last place of two f64 tensors
    (0 where both are the same infinity)."""
    import torch

    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    ia, ib = a.view(torch.int64), b.view(torch.int64)
    d = (ia - ib).abs()
    return torch.where(same, torch.zeros_like(d), d)


def max_abs_err(pairs) -> float:
    import torch

    m = 0.0
    for a, b in pairs:
        fin = torch.isfinite(a) & torch.isfinite(b)
        if a.dtype.is_floating_point and bool(fin.any()):
            m = max(m, float((a[fin] - b[fin]).abs().max()))
    return m


def make_inputs(K, L: int, seed: int, dev):
    """Lane states of the kind the main path gives the kernels, on the card."""
    return K.lane_state_tensors(K.sample_lane_state(L, seed), dev)


PRIM_ARGS = ("prim", "cont", "target", "ckend", "nf", "t", "saved", "unsaved",
             "pw", "W", "DR")


def prim_kw(s, kind, param) -> dict:
    """The stream and gap arguments of a primitive update on lanes ``s``;
    ``kind="indexed"`` takes the lanes' own ``law`` / ``s1`` / ``s2``."""
    stream = (s["key"], s["ctr"], s["nf"], s["mean"], s["horizon"])
    if kind == "indexed":
        stream += (s["law"], s["s1"], s["s2"])
    return dict(eps=1e-6, reg_cont=1, stream=stream, gap=(kind, param))


def adv_kw(s, kind, param) -> dict:
    if kind == "indexed":
        return dict(kind=kind, param=param, law=s["law"], lp=(s["s1"], s["s2"]))
    return dict(kind=kind, param=param)


def run_prim(K, x, kind, param, plain: bool):
    import torch

    s = {k: v.clone() for k, v in x.items()}
    fn = K.primitive_update if plain else K.masked_primitive_update
    out = fn(*(s[k] for k in PRIM_ARGS), **prim_kw(s, kind, param))
    torch.cuda.synchronize()
    return dict(zip(("t", "saved", "unsaved", "pw", "flags", "ctr", "tm"), out))


def run_adv(K, x, kind, param, plain: bool):
    import torch

    s = {k: v.clone() for k, v in x.items()}
    fn = K.stream_advance if plain else K.masked_stream_advance
    out = fn(s["mask"], s["ctr"], s["nf"], s["key"], s["mean"], s["horizon"],
             **adv_kw(s, kind, param))
    torch.cuda.synchronize()
    return dict(zip(("ctr", "tm"), out))


def prim_call(K, s, kind, param, plain: bool = False):
    """One primitive update on lanes ``s`` (kernel or plain version), as a
    call without arguments."""
    fn = K.primitive_update if plain else K.masked_primitive_update
    return lambda: fn(*(s[k] for k in PRIM_ARGS), **prim_kw(s, kind, param))


def adv_call(K, s, kind, param, plain: bool = False):
    fn = K.stream_advance if plain else K.masked_stream_advance
    return lambda: fn(s["mask"], s["ctr"], s["nf"], s["key"], s["mean"], s["horizon"],
                      **adv_kw(s, kind, param))


def timed(make, src, n_copies: int, want=None, what: str = "") -> float:
    """:func:`device_ms` of ``make(copy)`` over ``n_copies`` copies of the
    lanes ``src``; the first timed call's outputs are held against
    ``want`` (the plain version's), ``tm`` within ``TM_ULPS``."""
    import torch

    cs = [{k: v.clone() for k, v in src.items()} for _ in range(n_copies)]
    ms, out = device_ms([make(c) for c in cs], cs, src)
    for (k, w), g in zip((want or {}).items(), out):
        same = (int(ulp_dist(g, w).max()) <= TM_ULPS if k == "tm"
                else torch.equal(g, w))
        check(same, f"{what}: a timed call's {k} is not the plain version's")
    return ms


def sim_step_entry(name: str, replaces: str, tm: dict, launches: int, err: float,
                   **extra) -> dict:
    """A sim_step kernel's entry of the ``kernels`` line from its times
    ``tm`` (with the bytes and operations its bound counts)."""
    t_bytes = tm["bytes"] / PEAK_BYTES_S * 1e3
    t_ops = tm["ops"] / PEAK_F64_S * 1e3
    return {
        "name": name, "route": "cuda", "source": "src/repro_torch/kernels/csrc/sim_step.cu",
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None,
        "launch_floor_ms": tm["launch_floor_ms"], "host_call_ms": tm["host_call_ms"],
        **extra,
    }


def card_vs_cpu(on_gpu, on_cpu) -> float:
    """Hold two sweeps' cells to each other: the integer columns exact,
    the moments within rtol 1e-9.  Returns the largest relative gap."""
    worst = 0.0
    for a, b in zip(on_gpu.cells, on_cpu.cells):
        ints = [[r.n_exhausted, r.stats["n"]] + [r.stats[k] * r.stats["n"] for k in (
            "mean_faults", "mean_proactive_ckpts", "mean_regular_ckpts", "mean_migrations")]
            for r in (a, b)]
        check(ints[0] == ints[1], f"{a.cell.label}: counters differ card vs CPU")
        for k in ("mean_waste", "ci95_waste", "mean_makespan", "ci95_makespan"):
            rel = abs(a.stats[k] - b.stats[k]) / abs(b.stats[k])
            worst = max(worst, rel)
            check(rel <= 1e-9, f"{a.cell.label}: {k} card vs CPU rel {rel}")
    return worst


# --------------------------------------------------------------------------- #
# The cursor walks
# --------------------------------------------------------------------------- #
def _flatten(v, path: str, flat: dict):
    """Encode a walk call's argument: tensors go to ``flat`` under their
    path, tuples and lists recurse (and come back as tuples), anything else
    is kept as it is."""
    import torch

    if isinstance(v, torch.Tensor):
        flat[path] = v.clone()
        return ("tensor", path)
    if isinstance(v, (tuple, list)):
        return ("tuple", [_flatten(x, f"{path}.{i}", flat) for i, x in enumerate(v)])
    return ("value", v)


def _rebuild(code, d: dict):
    kind, v = code
    if kind == "tensor":
        return d[v]
    if kind == "tuple":
        return tuple(_rebuild(x, d) for x in v)
    return v


class WalkCall:
    """One captured walk call: its tensors (``flat``, clones taken before
    the call) and the recipe that rebuilds its arguments from them, so the
    call can be replayed on copies, under another law, with the kernel or
    with the plain version."""

    def __init__(self, name: str, args, kw):
        self.name = name  # "skip", "pop", "strike" or "silent"
        self.flat = {}
        self.args = [_flatten(a, f"a{i}", self.flat) for i, a in enumerate(args)]
        self.kw = {k: _flatten(v, k, self.flat) for k, v in kw.items() if k != "tally"}

    @property
    def lanes(self) -> int:
        return self.flat["a0"].numel()

    def call(self, K, d: dict, *, plain: bool = False, law=None):
        """A call without arguments on the tensors ``d`` (a copy of
        ``flat``); ``law`` replaces the laws: ``(kind, param)`` for every
        stream, or ``("indexed", laws)`` with the per-lane ``laws`` dict
        (law, s1, s2) on every stream."""
        args = [_rebuild(a, d) for a in self.args]
        kw = {k: _rebuild(v, d) for k, v in self.kw.items()}
        if law is not None:
            if law[0] == "indexed":
                lk = dict(law=law[1]["law"], lp=(law[1]["s1"], law[1]["s2"]))
                gap = ("indexed", 0.0)
            else:
                lk, gap = dict(law=None, lp=None), law
            if self.name in ("strike", "silent"):
                kw.update(kind=gap[0], param=gap[1], **lk)
            else:
                kw.update(f_gap=gap, fp_gap=gap, f_law=lk["law"], f_lp=lk["lp"],
                          fp_law=lk["law"], fp_lp=lk["lp"])
        if self.name == "strike":
            fn = K.strike_walk if plain else K.masked_strike_walk
        elif self.name == "silent":
            fn = K.silent_walk if plain else K.masked_silent_walk
        else:
            fn = K.prediction_walk if plain else K.masked_prediction_walk
        return lambda: fn(*args, **kw)

    def copy(self) -> dict:
        return {k: v.clone() for k, v in self.flat.items()}

    def run(self, K, *, plain: bool = False, law=None) -> tuple:
        import torch

        out = self.call(K, self.copy(), plain=plain, law=law)()
        torch.cuda.synchronize()
        return out


def capture_walks(grid, dev, at: int, silent: bool = False) -> dict:
    """Run ``grid`` on the card for ``at + 1`` outer iterations (one chunk,
    as the main path runs it) and keep the arguments of iteration ``at``'s
    three walks (and with ``silent`` its silent walk) as they were before
    each call: ``{"skip", "strike", "pop"[, "silent"]}`` ->
    :class:`WalkCall`.  torch_sim's walk wrappers are wrapped for the run
    and restored after it."""
    from repro_torch.core import torch_sim as PT
    from repro_torch.experiments import build_fused_layout

    real = {n: getattr(PT, n) for n in WALKS + ((SILENT,) if silent else ())}
    seen = {"skip": 0, "strike": 0, "silent": 0}
    cap = {}

    def pred(*args, **kw):
        if kw.get("until") is not None:
            if seen["skip"] == at:
                cap["skip"] = WalkCall("skip", args, kw)
            seen["skip"] += 1
        elif seen["strike"] == at + 1 and "pop" not in cap:
            cap["pop"] = WalkCall("pop", args, kw)
        return real["masked_prediction_walk"](*args, **kw)

    def strike(*args, **kw):
        if seen["strike"] == at:
            cap["strike"] = WalkCall("strike", args, kw)
        seen["strike"] += 1
        return real["masked_strike_walk"](*args, **kw)

    def sil(*args, **kw):
        if seen["silent"] == at:
            cap["silent"] = WalkCall("silent", args, kw)
        seen["silent"] += 1
        return real[SILENT](*args, **kw)

    layout = build_fused_layout(grid)
    PT.masked_prediction_walk, PT.masked_strike_walk = pred, strike
    if silent:
        setattr(PT, SILENT, sil)
    try:
        PT.simulate_batch_torch(layout.work_c, layout.plats_c, layout.strats_c,
                                layout.concat_spec(), device=dev, max_iters=at + 1)
        raise SmokeFailure(f"the grid finished within {at + 1} iterations")
    except RuntimeError as e:
        if "did not converge" not in str(e):
            raise
    finally:
        for n, fn in real.items():
            setattr(PT, n, fn)
    want = ["pop", "silent", "skip", "strike"] if silent else ["pop", "skip", "strike"]
    check(sorted(cap) == want, f"captured walks {sorted(cap)}")
    return cap


def walk_outputs(name: str, out) -> dict:
    keys = {"strike": ("t", "sf_ctr", "sf_time", "n_faults"),
            "silent": ("sf_ctr", "sf_time", "corrupt")}.get(
        name, ("la_ctr", "la_time", "tp_t0", "tp_ft", "tp_ctr", "fp_ctr", "fp_time"))
    return dict(zip(keys, out))


def walk_diff(got: dict, want: dict, what: str) -> tuple:
    """Hold a walk's outputs to the plain version's: integers equal, dates
    within ``TM_ULPS`` with nan and inf in the same places.  Returns the
    largest ulp distance and absolute error."""
    import torch

    ulps = 0
    for k, w in want.items():
        g = got[k]
        if w.dtype.is_floating_point:
            check(torch.equal(torch.isnan(g), torch.isnan(w)), f"{what}: {k} nan differs")
            u = int(ulp_dist(g, w).max())
            check(u <= TM_ULPS, f"{what}: {k} off by {u} ulp")
            ulps = max(ulps, u)
        else:
            check(torch.equal(g, w), f"{what}: {k} differs from the plain version")
    return ulps, max_abs_err((got[k], want[k]) for k in want)


def walk_work(c: WalkCall, out: dict, indexed: bool) -> dict:
    """What one call must do on its inputs: the draws (counter steps of
    every cursor), the lanes that walk, and the bytes (``BYTES_SKIP_*``,
    ``BYTES_REFILL_*``, ``BYTES_STRIKE_*``), with ``BYTES_LAW`` more per
    walking lane and stream when ``indexed``."""
    f = c.flat
    if c.name == "strike":
        walk = out["sf_ctr"] != f["a2"]
        draws = int((out["sf_ctr"] - f["a2"]).sum())
        masked = int(f["a0"].sum())
        head = BYTES_STRIKE_HEAD + (BYTES_CANCELS if "cancels.0" in f else 0)
        nbytes = (BYTES_STRIKE_MASK * c.lanes + head * masked
                  + BYTES_STRIKE_WALK * int(walk.sum()))
    elif c.name == "silent":
        walk = out["sf_ctr"] != f["a2"]
        draws = int((out["sf_ctr"] - f["a2"]).sum())
        nbytes = (BYTES_SILENT_MASK * c.lanes + BYTES_SILENT_HEAD * int(f["a0"].sum())
                  + BYTES_SILENT_WALK * int(walk.sum()))
    else:
        dl, df = out["la_ctr"] - f["a2"], out["fp_ctr"] - f["a7"]
        walk = (dl != 0) | (df != 0)
        draws = int(dl.sum() + df.sum())
        if c.name == "skip":
            nbytes = (BYTES_SKIP_MASK * c.lanes + BYTES_SKIP_HEAD * int(f["a0"].sum())
                      + BYTES_SKIP_WALK * int(walk.sum()))
        else:
            nbytes = BYTES_REFILL_MASK * c.lanes + BYTES_REFILL_WALK * int(walk.sum())
        if "q_eff" in f:
            nbytes += BYTES_TRUST * int(walk.sum())
    if indexed:
        nbytes += BYTES_LAW * (1 if c.name in ("strike", "silent") else 2) * int(walk.sum())
    return {"bytes": nbytes, "ops": OPS_GAP * draws, "draws": draws,
            "walking_lanes": int(walk.sum())}


def restored_eager_ms(make, src: dict, samples: int = 5) -> float:
    """Median time of one call issued from Python on a copy of ``src``
    restored before each sample (CUDA events around the call alone): the
    plain walks sync the host inside, so no CUDA graph can hold them."""
    import torch

    d = {k: v.clone() for k, v in src.items()}
    fn = make(d)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ms = []
    for _ in range(samples + 1):
        for k, v in d.items():
            v.copy_(src[k])
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    ms = ms[1:]  # the first is a warm-up
    return sorted(ms)[len(ms) // 2]


def time_walks(K, cap: dict, law, indexed: bool, what: str) -> dict:
    """Times of the walks of one captured iteration under ``law``: each
    kernel call on copies restored before every replay (``device_ms``),
    its outputs held to the plain version's, the plain version eagerly,
    the wrapper's host cost and the launch floor (128 lanes); bound
    inputs from :func:`walk_work`.  Returns {name: times}."""
    import torch

    out = {}
    for name, c in cap.items():
        want = walk_outputs(name, c.run(K, plain=True, law=law))
        work = walk_work(c, want, indexed)
        copy_bytes = sum(v.numel() * v.element_size() for v in c.flat.values())
        n_copies = max(2, math.ceil(3 * L2_BYTES / copy_bytes))
        cs = [c.copy() for _ in range(n_copies)]
        ms, first = device_ms([c.call(K, d, law=law) for d in cs], cs, c.flat)
        walk_diff(walk_outputs(name, first), want, f"{what} {name} (timed)")
        small = {k: v[:128].clone() for k, v in c.flat.items()}
        floor_copies = [{k: v.clone() for k, v in small.items()} for _ in range(64)]
        small_law = law
        if law is not None and law[0] == "indexed":
            small_law = ("indexed", {k: v[:128] for k, v in law[1].items()})
        out[name] = {
            "ms": ms,
            "plain_ms": restored_eager_ms(lambda d: c.call(K, d, plain=True, law=law), c.flat),
            "host_call_ms": eager_ms(c.call(K, c.copy(), law=law), 200),
            "launch_floor_ms": device_ms([c.call(K, d, law=small_law) for d in floor_copies],
                                         floor_copies, small)[0],
            "copies": n_copies, **work,
        }
        torch.cuda.synchronize()
    return out


def walk_entries(times: dict, launches: dict, err: dict, regs: dict, suffix: str,
                 **extra) -> list:
    """The two walk kernels' entries of the ``kernels`` line: the
    prediction walk's numbers are the means of its two calls of an outer
    iteration (the skip walk and the pop), each also given alone."""
    pred = {k: (times["skip"][k] + times["pop"][k]) / 2
            for k in ("ms", "plain_ms", "host_call_ms", "launch_floor_ms", "bytes", "ops")}
    out = []
    for name, tm, parts in (("masked_prediction_walk", pred, ("skip", "pop")),
                            ("masked_strike_walk", times["strike"], ("strike",))):
        full = name + suffix
        out.append(sim_step_entry(
            full, REPLACES_ADV, tm, launches[full], err[full],
            calls={p: times[p] for p in parts}, registers=regs.get(full), **extra))
    return out


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of each sim_step kernel from nvcc's
    ``-Xptxas -v`` output: {wrapper name: {...}}."""
    import re

    names = {"slab_prediction_skip_kernel": "masked_slab_prediction_skip",
             "slab_strike_walk_kernel": "masked_slab_strike_walk",
             "slab_silent_walk_kernel": "masked_slab_silent_walk",
             "primitive_update_kernel": "masked_primitive_update",
             "stream_advance_kernel": "masked_stream_advance",
             "prediction_walk_kernel": "masked_prediction_walk",
             "strike_walk_kernel": "masked_strike_walk",
             "silent_walk_kernel": SILENT}
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = next((w + ("[indexed]" if "ILb1E" in m.group(1) else "")
                        for k, w in names.items() if k in m.group(1)), None)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out.setdefault(cur, {}).update(spill_stores=int(m.group(1)),
                                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
    return out


def ptxas_kernels(log: str, pattern: str) -> dict:
    """Registers, static shared memory and spill bytes of each kernel in
    nvcc's ``-Xptxas -v`` output whose mangled name matches ``pattern``
    (group 1: the kernel's name; its template integers follow):
    {"name<i, j>": {...}}."""
    import re

    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(pattern + r"I((?:Li\d+E)+)E", m.group(1))
            cur = None if k is None else "{}<{}>".format(
                k.group(1), ", ".join(re.findall(r"Li(\d+)E", k.group(2))))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out.setdefault(cur, {}).update(spill_stores=int(m.group(1)),
                                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            sm = re.search(r"(\d+) bytes smem", ln)
            out.setdefault(cur, {}).update(registers=int(m.group(1)),
                                           static_smem_bytes=int(sm.group(1)) if sm else 0)
    return out


def eager_ms(fn, reps: int) -> float:
    """Mean time of one call issued from Python, CUDA events around
    ``reps`` back-to-back calls after a warm-up.  Where the host issues
    launches slower than the card runs them, this is the host's rate."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(calls, copies=None, src=None, samples: int = 10):
    """Median device time of one call.  The calls are captured in one CUDA
    graph and the replays timed between CUDA events.  ``calls[i]`` works
    on ``copies[i]`` (together three times the L2, so each call finds its
    lanes in device memory); given copies, a second graph rewrites every
    copy from ``src`` before each timed replay (the sim_step kernels
    update state in place) and then reads a buffer larger than the L2, so
    the rewritten lines are flushed before the timed span opens; the card
    is still busy with it when the timed replay is issued, so the span
    holds no host time.  Without copies the calls must leave their inputs
    as they are, so every replay does the same work.  Returns the ms per
    call and the outputs of the first call of the last replay."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in calls:
            f()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    prep = None
    if copies is not None:
        flush = torch.ones(int(3 * L2_BYTES) // 4, dtype=torch.float32,
                           device=next(iter(src.values())).device)
        prep = torch.cuda.CUDAGraph()
        with torch.cuda.graph(prep):
            for c in copies:
                for k, v in c.items():
                    v.copy_(src[k])
            flush.sum()
        prep.replay()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [f() for f in calls]
    ms = []
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(samples):
        if prep is not None:
            prep.replay()
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b) / len(calls))
    return sorted(ms)[len(ms) // 2], outs[0]


# --------------------------------------------------------------------------- #
# The checkpoint path
# --------------------------------------------------------------------------- #
def bits(t):
    """The bit pattern of an f32 tensor (other tensors as they are)."""
    import torch

    return t.view(torch.int32) if t.dtype == torch.float32 else t


def same_bits(a, b) -> bool:
    import torch

    return a.shape == b.shape and torch.equal(bits(a), bits(b))


def make_state(seed: int, dev):
    """SmolLM-135M's training state on the card, from ``seed``: params
    N(0, 0.02), AdamW m N(0, 1e-3) and v = m^2; and the next step's
    state, every leaf times ``1 + DELTA_REL * N(0, 1)``."""
    import torch
    from repro_torch.checkpoint.store import map_with_keys
    from repro_torch.configs.smollm_135m import param_shapes

    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def normal(std):
        return lambda shape: torch.randn(shape, generator=g, device=dev) * std

    m = {k: normal(1e-3)(shape) for k, shape in param_shapes().items()}
    state = {
        "params": {k: normal(0.02)(shape) for k, shape in param_shapes().items()},
        "m": m,
        "v": map_with_keys(lambda _, x: x * x, m),
    }
    step2 = map_with_keys(
        lambda _, x: x * (1.0 + DELTA_REL * torch.randn(x.shape, generator=g, device=dev)),
        state)
    return state, step2


def codec_err_ratio(got, want, base=None) -> float:
    """Largest ``|got - want|`` over its bound: half the block's code step,
    ``max(absmax / 127, 1e-12) / 2`` with absmax taken over ``want`` (or
    ``want - base``, the delta), widened by the rounding of ``x / scale``
    (at most 127 ulp of the step's 2^-24) and of the f32 operands.  At
    most 1 when the round trip is right."""
    import torch

    w = want.reshape(-1).float()
    d = w if base is None else w - base.reshape(-1).float()
    n = d.numel()
    am = torch.nn.functional.pad(d.abs(), (0, (-n) % 256)).view(-1, 256).amax(1)
    step = torch.clamp(am / 127.0, min=1e-12).repeat_interleave(256)[:n]
    mag = w.abs() if base is None else w.abs() + base.reshape(-1).float().abs()
    tol = step / 2 * (1 + 2.0**-14) + 2.0**-22 * mag
    return float(((got.reshape(-1).float() - w).abs() / tol).max())


def codec_bytes(n: int, delta: bool, quantize: bool) -> int:
    """Bytes one launch must move on an ``n``-element leaf: quantize reads
    4 B an element (8 with prev) and writes 1 B a padded element and 4 B
    a block; dequantize reads 1 B a code it decodes and 4 B a block (and
    4 B of prev an element) and writes 4 B an element."""
    nb = -(-n // 256)
    if quantize:
        return 4 * n * (2 if delta else 1) + 256 * nb + 4 * nb
    return n + 4 * nb + 4 * n * (1 if delta else 0) + 4 * n


def check_codec_pair(CK, x, prev, what, err):
    """Both kernels against their plain versions on the flat leaf ``x``
    (and ``prev``): codes, scales and decoded values bit-equal.  Raises
    ``err[name]`` to the largest absolute difference seen.  Returns the
    kernels' (q, s)."""
    q, s = CK.quantize_blocks(x, prev)
    qr, sr = CK.quantize_ref(x, prev)
    d = CK.dequantize_blocks(q, s, prev, n=x.numel())
    dr = CK.dequantize_ref(q, s, prev, n=x.numel())
    err["quantize_blocks"] = max(err["quantize_blocks"], float(
        (q.int() - qr.int()).abs().max()), max_abs_err([(s, sr)]))
    err["dequantize_blocks"] = max(err["dequantize_blocks"], max_abs_err([(d, dr)]))
    check(same_bits(q, qr), f"{what}: quantize_blocks codes differ from the plain version")
    check(same_bits(s, sr), f"{what}: quantize_blocks scales differ from the plain version")
    check(same_bits(d, dr), f"{what}: dequantize_blocks differs from the plain version")
    return q, s


def checkpoint_phases(dev) -> list:
    """Phases 7-10: the codec kernels against their plain versions and the
    host codec, the checkpoint path (store, async and buddy tiers) on
    SmolLM-135M's training state, and the kernels' times.  Returns the
    two kernels' entries of the ``kernels`` line."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import (
        AsyncCheckpointer, BuddyMemoryCheckpoint, CheckpointStore,
    )
    from repro_torch.checkpoint import codec as host_codec
    from repro_torch.checkpoint.store import decode_leaf, encode_leaf, flatten_with_keys
    from repro_torch.kernels import ckpt_codec as CK

    # ---- 7. kernels against their plain versions, on the card ---------- #
    t0 = time.monotonic()
    err = {"quantize_blocks": 0.0, "dequantize_blocks": 0.0}
    edge = {}
    for seed in (1, 2):
        x_np, p_np = CK.sample_codec_leaf(seed)
        x, p = torch.from_numpy(x_np).to(dev), torch.from_numpy(p_np).to(dev)
        for prev, prev_np in ((None, None), (p, p_np)):
            what = f"edge leaf {seed}" + (" (delta)" if prev is not None else "")
            q, s = check_codec_pair(CK, x, prev, what, err)
            # and against the host codec, which owns the format: the codes
            # equal; the scales equal or both NaN (the card's subtract
            # writes its own NaN where x86 keeps the operand's payload)
            with np.errstate(invalid="ignore"):
                pay, meta = host_codec.encode_array(x_np, prev_np)
            qn = meta["nblocks"] * 256
            check(np.array_equal(q.cpu().numpy().reshape(-1).view(np.uint8), pay[:qn]),
                  f"{what}: codes differ from the host codec")
            sc = s.cpu().numpy().reshape(-1)
            check(np.array_equal(sc, pay[qn:].view(np.float32), equal_nan=True),
                  f"{what}: scales differ from the host codec")
            edge[what] = {"nan_scales": int(np.isnan(sc).sum()),
                          "inf_scales": int(np.isinf(sc).sum()),
                          "floor_scales": int((sc == np.float32(1e-12)).sum())}
    state, step2 = make_state(STATE_SEED, dev)
    flat, flat2 = flatten_with_keys(state), flatten_with_keys(step2)
    codec_keys = [k for k, v in flat.items() if v.numel() >= 1024]
    for k in codec_keys:
        check_codec_pair(CK, flat[k].reshape(-1), None, k, err)
        check_codec_pair(CK, flat2[k].reshape(-1), flat[k].reshape(-1), k + " (delta)", err)
    torch.cuda.synchronize()
    n_elems = sum(flat[k].numel() for k in codec_keys)
    n_blocks = sum(-(-flat[k].numel() // 256) for k in codec_keys)
    state_bytes = sum(v.numel() * v.element_size() for v in flat.values())
    emit("codec_check", seconds=time.monotonic() - t0, edge=edge,
         state_leaves=len(flat), codec_leaves=len(codec_keys), elements=n_elems,
         blocks=n_blocks, state_bytes=state_bytes,
         compared="codes, scales and decoded values bit-equal to the plain "
                  "versions; edge leaves also to the host codec")

    # ---- 8. the card's payload against the host codec ------------------ #
    t0 = time.monotonic()
    host_check = {}
    for k in ("params/embed", STACKED_LEAF):
        for prev in (None, flat[k]):
            x = flat[k] if prev is None else flat2[k]
            pay, meta = encode_leaf(x, prev)
            x_np = x.cpu().numpy()
            p_np = None if prev is None else prev.cpu().numpy()
            hpay, hmeta = host_codec.encode_array(x_np, p_np)
            what = f"{k} ({meta['codec']})"
            check(meta == hmeta, f"{what}: manifest entry differs from the host codec's")
            check(np.array_equal(pay, hpay), f"{what}: payload bytes differ from the host codec's")
            back = decode_leaf(pay, meta, prev, dev)
            hback = host_codec.decode_array(pay, meta, p_np)
            check(np.array_equal(back.cpu().numpy().view(np.uint32), hback.view(np.uint32)),
                  f"{what}: dequantize_blocks differs from the host decoder")
            host_check[what] = {"payload_bytes": int(pay.nbytes), "nblocks": meta["nblocks"]}
    emit("codec_host", seconds=time.monotonic() - t0, leaves=host_check,
         compared="payload bytes equal to encode_array's; decoded bit-equal to decode_array's")

    # ---- 9. the checkpoint path ---------------------------------------- #
    CK.quantize_blocks.launches = 0
    CK.dequantize_blocks.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    n_codec = len(codec_keys)
    per_codec = {}

    def counted(fn):
        q0, d0 = CK.quantize_blocks.launches, CK.dequantize_blocks.launches
        out = fn()
        return out, CK.quantize_blocks.launches - q0, CK.dequantize_blocks.launches - d0

    with tempfile.TemporaryDirectory(prefix="ckpt_smoke_") as tmp:
        for codec in ("raw", "int8", "int8_delta"):
            store = CheckpointStore(os.path.join(tmp, codec), codec)
            want_q = 0 if codec == "raw" else n_codec
            m_save, nq, nd = counted(lambda: store.save(1, state))
            check(nq == want_q and nd == 0, f"{codec}: blocking save launched {nq} quantize_blocks")
            ac = AsyncCheckpointer(store, keep=1)
            tree, prev = (step2, state) if codec == "int8_delta" else (state, None)
            (c_block, nq, nd) = counted(lambda: ac.save(2, tree, prev_tree=prev))
            ac.wait()
            check(nq == want_q, f"{codec}: async save launched {nq} quantize_blocks")
            check(ac.durable_step == 2 and store.steps() == [2],
                  f"{codec}: durable step {ac.durable_step}, steps {store.steps()}")
            m = ac.metrics
            got, nq, nd = counted(lambda: store.restore_latest(target=tree, prev_tree=prev))
            check(got is not None and got[0] == 2, f"{codec}: restore_latest gave {got and got[0]}")
            check(nd == want_q, f"{codec}: restore launched {nd} dequantize_blocks")
            back = flatten_with_keys(got[1])
            base = flat if codec == "int8_delta" else {}
            worst = 0.0
            for k, want in flatten_with_keys(tree).items():
                b = back[k]
                check(b.device == want.device and b.dtype == want.dtype and b.shape == want.shape,
                      f"{codec}: {k} restored as {b.dtype} {tuple(b.shape)} on {b.device}")
                if codec == "raw" or k not in codec_keys:
                    check(torch.equal(b, want), f"{codec}: {k} not restored exactly")
                else:
                    r = codec_err_ratio(b, want, base.get(k))
                    check(r <= 1.0, f"{codec}: {k} off by {r} of its bound")
                    worst = max(worst, r)
            del got, back
            per_codec[codec] = {
                "blocking_save": m_save, "async": m, "c_block_returned": c_block,
                "ratio": m["raw_bytes"] / m["stored_bytes"], "max_err_over_bound": worst,
            }
            emit("ckpt_save", codec=codec, **{k: m[k] for k in (
                "t_snapshot", "t_total", "raw_bytes", "stored_bytes", "c_block", "c_full")},
                blocking_t_snapshot=m_save["t_snapshot"], blocking_t_total=m_save["t_total"],
                raw_over_stored=m["raw_bytes"] / m["stored_bytes"], max_err_over_bound=worst)
        bm = BuddyMemoryCheckpoint(n_nodes=2)
        t_buddy = bm.save(3, state, rank=0)
        got = bm.restore(0, lost=True)
        check(got is not None and got[0] == 3, "buddy: node loss lost the snapshot")
        t1 = time.monotonic()
        hb = flatten_with_keys(got[1])
        for k, want in flat.items():
            check(hb[k].device.type == "cpu" and torch.equal(hb[k].to(dev), want),
                  f"buddy: {k} not restored exactly")
        t_buddy_restore = time.monotonic() - t1
        del got, hb, bm
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"quantize_blocks": CK.quantize_blocks.launches,
                "dequantize_blocks": CK.dequantize_blocks.launches}
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the checkpoint path")
    emit("ckpt_path", seconds=wall, state_bytes=state_bytes, launches=launches,
         launches_per_codec_save=n_codec, buddy_save_s=t_buddy,
         buddy_restore_and_check_s=t_buddy_restore,
         note="each codec: a blocking save, an async save with wait, restore_latest "
              "onto the card; then a buddy save and restore with lost=True")

    # ---- 10. times on embed and over the state ------------------------- #
    t0 = time.monotonic()
    emb, emb2 = flat["params/embed"].reshape(-1), flat2["params/embed"].reshape(-1)
    n_emb = emb.numel()
    reps = 10
    timing = {}
    for delta in (False, True):
        x, p = (emb2, emb) if delta else (emb, None)
        qe, se = CK.quantize_ref(x, p)
        leaves = [(flat2[k].reshape(-1), flat[k].reshape(-1)) if delta
                  else (flat[k].reshape(-1), None) for k in codec_keys]
        coded = [CK.quantize_ref(x_, p_) + (x_.numel(),) for x_, p_ in leaves]
        for quant in (True, False):
            if quant:
                kern = lambda x=x, p=p: CK.quantize_blocks(x, p)  # noqa: E731
                plain = lambda x=x, p=p: CK.quantize_ref(x, p)  # noqa: E731
                over = [lambda x_=x_, p_=p_: CK.quantize_blocks(x_, p_) for x_, p_ in leaves]
            else:
                kern = lambda q=qe, s=se, p=p: CK.dequantize_blocks(q, s, p, n=n_emb)  # noqa: E731
                plain = lambda q=qe, s=se, p=p: CK.dequantize_ref(q, s, p, n=n_emb)  # noqa: E731
                over = [lambda c=c, p_=p_: CK.dequantize_blocks(c[0], c[1], p_, n=c[2])
                        for c, (_, p_) in zip(coded, leaves)]
            name = "quantize_blocks" if quant else "dequantize_blocks"
            ms, out = device_ms([kern] * reps)
            pms, pout = device_ms([plain] * reps)
            for a, b in zip(out if quant else [out], pout if quant else [pout]):
                check(same_bits(a, b), f"{name}: a timed call differs from the plain version")
            lms = None
            if not quant and not delta:
                # one PyTorch call computes the plain decode: the broadcast
                # product promotes the codes to f32 and rounds q*s once.
                # (The delta decode has none: addcmul may fuse the product
                # and the sum into one rounding.)
                lms, lout = device_ms([lambda q=qe, s=se: torch.mul(q, s)] * reps)
                check(same_bits(lout.reshape(-1)[:n_emb], out),
                      f"{name}: torch.mul differs from the kernel")
            sms, _ = device_ms(over)
            ops = OPS_QUANT + delta if quant else OPS_DEQUANT + delta
            nbytes = codec_bytes(n_emb, delta, quant)
            sbytes = sum(codec_bytes(x_.numel(), delta, quant) for x_, _ in leaves)
            t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops * n_emb / PEAK_F32_S * 1e3
            timing[(name, delta)] = {
                "ms": ms, "plain_ms": pms, "library_ms": lms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "state_ms": sms * len(over), "state_bytes": sbytes,
                "state_bound_ms": max(sbytes / PEAK_BYTES_S * 1e3,
                                      ops * n_elems / PEAK_F32_S * 1e3),
            }
            del out, pout
    emit("codec_timing", seconds=time.monotonic() - t0, leaf="params/embed",
         leaf_elements=n_emb, launches_per_sample=reps,
         note="CUDA graphs of launches on unchanged inputs: neither kernel updates "
              "its inputs, so every launch does the work the bound counts; embed "
              "moves 2.3x the L2 a launch; library: torch.mul(q, s) for the plain "
              "decode (bit-equal to the kernel), none for quantize or the delta decode",
         times={f"{k[0]}{'/delta' if k[1] else ''}": v for k, v in timing.items()})

    kernels = []
    for name in ("quantize_blocks", "dequantize_blocks"):
        t, td = timing[(name, False)], timing[(name, True)]
        kernels.append({
            "name": name, "route": "cuda", "source": CODEC_SOURCE,
            "replaces": CODEC_REPLACES[name], "launches": launches[name],
            "max_abs_err": err[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": f"params/embed, {n_emb} f32",
            "delta_ms": td["ms"], "delta_plain_ms": td["plain_ms"],
            "delta_bound_ms": td["bound_ms"],
            "state_ms": t["state_ms"], "state_bound_ms": t["state_bound_ms"],
            "delta_state_ms": td["state_ms"], "delta_state_bound_ms": td["state_bound_ms"],
        })
    return kernels


# --------------------------------------------------------------------------- #
# The serving path
# --------------------------------------------------------------------------- #
def attn_close(got, want, what: str) -> float:
    """Hold a kernel's output to its plain version's (or a library call's)
    within ATTN_TOL of the dtype; returns the largest absolute error."""
    import torch

    tol = ATTN_TOL[str(want.dtype).split(".")[-1]]
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: {got.dtype} {tuple(got.shape)} against {want.dtype} {tuple(want.shape)}")
    g, w = got.float(), want.float()
    bad = (g - w).abs() > tol + tol * w.abs()
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} values off by more than {tol} "
          f"(max abs err {float((g - w).abs().max())})")
    return float((g - w).abs().max())


def flash_inputs(B, S, T, H, KV, hd, dt, seed, dev):
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=dev).to(dt)
                 for shape in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd)))


def device_kernels(fn, names) -> dict:
    """How many times each device kernel named in ``names`` ran in one
    call of ``fn``, counted in a ``torch.profiler`` trace of the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {n: sum(n in e.name for e in prof.events()) for n in names}


def serving_phases(dev, launch_floor_ms: float) -> list:
    """Phases 11-14: the attention kernels against their plain versions,
    the model on the card against the port on the CPU, the serving path,
    and the kernels' times.  Returns the two kernels' entries of the
    ``kernels`` line."""
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.checkpoint.store import map_with_keys
    from repro_torch.configs import get
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import fault_trace, serve
    from repro_torch.models import LanguageModel, RuntimeFlags

    cfg = get("smollm-135m")
    H, KV, hd, L = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_layers
    B, S = REQUESTS, PROMPT_LEN
    max_seq = PROMPT_LEN + GEN + 8
    err = {"flash_attention_bhsd": 0.0, "decode_attention_bhd": 0.0}

    # ---- 11. kernels against their plain versions, the path's shapes ---- #
    t0 = time.monotonic()
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[-1]
        for what, s_, t_, causal, bhsd in (
            ("path", S, S, True, False), ("bhsd_group1", S, S, True, True),
            ("ragged_1000", 1000, 1000, True, False), ("non_causal", S, S, False, False),
            ("prefix_128_of_1000", 128, 1000, True, False),
        ):
            q, k, v = flash_inputs(B, s_, t_, H, KV, hd, dt, len(cases), dev)
            if bhsd:  # the reference's layout, K/V broadcast to every query head
                q = q.transpose(1, 2).reshape(B * H, s_, hd).contiguous()
                k = k.repeat_interleave(H // KV, dim=2).transpose(1, 2).reshape(B * H, t_, hd).contiguous()
                v = v.repeat_interleave(H // KV, dim=2).transpose(1, 2).reshape(B * H, t_, hd).contiguous()
            tc0 = FA.flash_attention_bhsd.tc_launches
            if bhsd:
                got, want = FA.flash_attention_bhsd(q, k, v, causal), FA.flash_attention_ref(q, k, v, causal)
            else:
                got, want = ops.flash_attention(q, k, v, causal), FA.attention_ref(q, k, v, causal)
            torch.cuda.synchronize()
            variant = "tc" if FA.flash_attention_bhsd.tc_launches > tc0 else "simt"
            check(variant == ("tc" if dt == torch.bfloat16 else "simt"),
                  f"flash_attention_bhsd/{what}/{dn} took the {variant} kernel")
            e = attn_close(got, want, f"flash_attention_bhsd/{what}/{dn}")
            err["flash_attention_bhsd"] = max(err["flash_attention_bhsd"], e)
            cases.append({"kernel": "flash_attention_bhsd", "case": what, "dtype": dn,
                          "variant": variant, "q": list(q.shape), "k": list(k.shape),
                          "causal": causal, "max_abs_err": e})
        g = torch.Generator(device=dev)
        g.manual_seed(20)
        kc = torch.randn((B, max_seq, KV, hd), generator=g, device=dev).to(torch.bfloat16)
        vc = torch.randn((B, max_seq, KV, hd), generator=g, device=dev).to(torch.bfloat16)
        qd = torch.randn((B, 1, H, hd), generator=g, device=dev).to(dt)
        R = DA.SPLIT_ROWS  # pos -1: every split live; R - 1 and R: a split's edge
        for pos in (-1, 0, R - 1, R, 511, 1023, max_seq - 1):
            p = torch.tensor(pos, dtype=torch.int32, device=dev)
            got = ops.decode_attention(qd, kc, vc, p)
            want = DA.attention_ref(qd[:, 0], kc, vc, p).unsqueeze(1)
            torch.cuda.synchronize()
            e = attn_close(got, want, f"decode_attention_bhd/pos{pos}/{dn}")
            err["decode_attention_bhd"] = max(err["decode_attention_bhd"], e)
            cases.append({"kernel": "decode_attention_bhd", "case": f"pos {pos}",
                          "q_dtype": dn, "cache": list(kc.shape), "max_abs_err": e})
        # the reference's layout: (BH, hd) over a broadcast (BH, S_max, hd) cache
        kb = kc.repeat_interleave(H // KV, dim=2).transpose(1, 2).reshape(B * H, max_seq, hd).to(dt)
        vb = vc.repeat_interleave(H // KV, dim=2).transpose(1, 2).reshape(B * H, max_seq, hd).to(dt)
        qb = qd[:, 0].reshape(B * H, hd).contiguous()
        p = torch.tensor(700, dtype=torch.int32, device=dev)
        e = attn_close(DA.decode_attention_bhd(qb, kb, vb, p),
                       DA.decode_attention_ref(qb, kb, vb, p), f"decode_attention_bhd/bhd/{dn}")
        err["decode_attention_bhd"] = max(err["decode_attention_bhd"], e)
        cases.append({"kernel": "decode_attention_bhd", "case": "bhd group 1, pos 700",
                      "q_dtype": dn, "cache": list(kb.shape), "max_abs_err": e})
    emit("attn_check", seconds=time.monotonic() - t0, cases=cases, tol=ATTN_TOL)

    # ---- 12. the model on the card against the port on the CPU --------- #
    # (the CPU side runs on one thread, so its summation order does not
    # depend on how many threads the host hands it)
    t0 = time.monotonic()
    cpu_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    small = dataclasses.replace(cfg, num_layers=2)
    flags = RuntimeFlags(compute_dtype=torch.float32)
    m_cpu, m_gpu = LanguageModel(small, flags), LanguageModel(small, flags)
    p_cpu = m_cpu.init(torch.Generator().manual_seed(SERVE_SEED))
    p_gpu = map_with_keys(lambda _, x: x.to(dev), p_cpu)
    toks = np.random.default_rng(SERVE_SEED).integers(0, small.vocab_size, (2, 128)).astype(np.int32)
    lc, cc = m_cpu.prefill(p_cpu, torch.from_numpy(toks), 128 + 16)
    lg, cg = m_gpu.prefill(p_gpu, torch.from_numpy(toks).to(dev), 128 + 16)
    diffs = {"prefill": float((lg.cpu() - lc).abs().max()), "decode_same_cache": 0.0,
             "decode_own_cache": 0.0}
    same_tokens = True
    tok = lc[:, -1].argmax(-1).to(torch.int32)[:, None]
    for _ in range(8):
        synced = {"pos": cc["pos"].to(dev, copy=True),
                  "blocks": tuple({k: v.to(dev, copy=True) for k, v in b.items()}
                                  for b in cc["blocks"])}
        ls, _ = m_gpu.decode_step(p_gpu, synced, tok.to(dev))
        lc, cc = m_cpu.decode_step(p_cpu, cc, tok)
        lg, cg = m_gpu.decode_step(p_gpu, cg, tok.to(dev))
        diffs["decode_same_cache"] = max(diffs["decode_same_cache"], float((ls.cpu() - lc).abs().max()))
        diffs["decode_own_cache"] = max(diffs["decode_own_cache"], float((lg.cpu() - lc).abs().max()))
        same_tokens &= bool(torch.equal(lg.cpu().argmax(-1), lc.argmax(-1)))
        tok = lc[:, -1].argmax(-1).to(torch.int32)[:, None]
    torch.set_num_threads(cpu_threads)
    for k, tol in CARD_CPU_TOL.items():
        check(diffs[k] <= tol, f"card vs CPU: {k} logits differ by {diffs[k]} > {tol}")
    emit("serve_card_vs_cpu", seconds=time.monotonic() - t0, layers=2, batch=2, prompt=128,
         decode_steps=8, compute="float32", max_abs_logit=float(lc.abs().max()),
         max_abs_diff=diffs, tol=CARD_CPU_TOL, greedy_tokens_equal=same_tokens)
    del m_cpu, m_gpu, p_cpu, p_gpu, cc, cg

    # ---- 13. the path: serve SmolLM-135M, without and with faults ------ #
    kw = dict(requests=REQUESTS, prompt_len=PROMPT_LEN, gen=GEN,
              snapshot_every=SNAPSHOT_EVERY, seed=SERVE_SEED, device=dev)
    FA.flash_attention_bhsd.launches = 0
    FA.flash_attention_bhsd.tc_launches = 0
    DA.decode_attention_bhd.launches = 0
    torch.cuda.synchronize()
    clean = serve(cfg, **kw)
    launches = {"flash_attention_bhsd": FA.flash_attention_bhsd.launches,
                "decode_attention_bhd": DA.decode_attention_bhd.launches}
    tc_launches = FA.flash_attention_bhsd.tc_launches
    check(clean["decode_steps"] == GEN - 1, f"fault-free run took {clean['decode_steps']} steps")
    check(launches["flash_attention_bhsd"] == L,
          f"flash_attention_bhsd launched {launches['flash_attention_bhsd']} times in one prefill")
    check(tc_launches == L, f"{tc_launches} of the prefill's {L} flash launches took the "
          "tensor-core kernel")
    check(launches["decode_attention_bhd"] == L * clean["decode_steps"],
          f"decode_attention_bhd launched {launches['decode_attention_bhd']} times in "
          f"{clean['decode_steps']} decode steps")
    toks_clean = clean["tokens"]
    check(tuple(toks_clean.shape) == (REQUESTS, GEN), f"tokens {tuple(toks_clean.shape)}")
    check(bool(((toks_clean >= 0) & (toks_clean < cfg.vocab_size)).all()), "token out of range")

    mtbf = clean["decode_s"] / 4
    times = fault_trace(SERVE_SEED, mtbf)[:MAX_FAULTS]
    FA.flash_attention_bhsd.launches = 0
    FA.flash_attention_bhsd.tc_launches = 0
    DA.decode_attention_bhd.launches = 0
    faulted = serve(cfg, fault_times=times, **kw)
    f_launch = {"flash_attention_bhsd": FA.flash_attention_bhsd.launches,
                "decode_attention_bhd": DA.decode_attention_bhd.launches}
    check(FA.flash_attention_bhsd.tc_launches == L,
          "the faulted run's prefill did not take the tensor-core flash kernel")
    check(faulted["faults"] >= 1, "no fault landed in the faulted run")
    check(torch.equal(faulted["tokens"], toks_clean),
          f"faulted run's tokens differ from the fault-free run's in "
          f"{int((faulted['tokens'] != toks_clean).sum())} places")
    check(faulted["decode_steps"] == GEN - 1 + faulted["redecoded"], "replayed steps miscounted")
    check(f_launch["flash_attention_bhsd"] == L
          and f_launch["decode_attention_bhd"] == L * faulted["decode_steps"],
          f"faulted run launches {f_launch} for {faulted['decode_steps']} decode steps")

    # the dense-attention path against the kernel path: same weights, same prompts
    g = torch.Generator(device=dev)
    g.manual_seed(SERVE_SEED)
    m_k = LanguageModel(cfg)
    params = m_k.cast_params(m_k.init(g))
    m_d = LanguageModel(cfg, RuntimeFlags(attn_impl="dense"))
    prompts = torch.from_numpy(np.random.default_rng(SERVE_SEED).integers(
        0, cfg.vocab_size, (REQUESTS, PROMPT_LEN)).astype(np.int32)).to(dev)
    lk, ck = m_k.prefill(params, prompts, max_seq)
    check(torch.equal(lk[:, -1].argmax(-1).to(torch.int32).cpu(), toks_clean[:, 0]),
          "the kernel prefill's greedy tokens are not serve()'s first tokens")
    ld, cd = m_d.prefill(params, prompts, max_seq)
    first = lk[:, -1].argmax(-1).to(torch.int32)[:, None]
    lk2, _ = m_k.decode_step(params, ck, first)
    ld2, _ = m_d.decode_step(params, cd, first)
    dense_vs_kernel = {}
    for what, a, b in (("prefill", ld, lk), ("decode", ld2, lk2)):
        a, b = a.float(), b.float()
        scale = float(b.abs().max())
        d = {"max_abs_diff": float((a - b).abs().max()), "max_abs_logit": scale,
             "max_over_max_logit": float((a - b).abs().max()) / scale,
             "rel_l2": float((a - b).norm() / b.norm())}
        check(d["max_over_max_logit"] <= DENSE_TOL and d["rel_l2"] <= DENSE_TOL,
              f"dense {what} logits off the kernel run's: {d}")
        dense_vs_kernel[what] = d
    del ck, cd, ld, ld2, lk2

    steps_ms = clean["decode_s"] * 1e3 / clean["decode_steps"]
    emit("serve_path", model=cfg.name, layers=L, params=cfg.param_count(),
         requests=REQUESTS, prompt_len=PROMPT_LEN, gen=GEN, max_seq=max_seq,
         kv_cache_bytes=2 * L * REQUESTS * max_seq * KV * hd * 2,
         prefill_s=clean["prefill_s"], decode_s=clean["decode_s"],
         decode_ms_per_token=steps_ms, tokens_per_s=REQUESTS * GEN / clean["wall_s"],
         wall_s=clean["wall_s"], launches=launches,
         flash_tc_launches=tc_launches,
         faulted={"mtbf_s": mtbf, "fault_times_s": times, "faults": faulted["faults"],
                  "redecoded": faulted["redecoded"], "decode_steps": faulted["decode_steps"],
                  "wall_s": faulted["wall_s"], "decode_s": faulted["decode_s"],
                  "launches": f_launch, "tokens_equal_fault_free": True},
         dense_vs_kernel=dense_vs_kernel, dense_tol=DENSE_TOL,
         nvidia_smi=subprocess.run(
             ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
             capture_output=True, text=True, check=True).stdout.strip())

    # ---- 14. times at the path's shapes -------------------------------- #
    t0 = time.monotonic()
    timing = {}
    # flash: one layer's prefill attention, bf16; input sets cycled so the
    # calls read three times the L2
    set_bytes = 2 * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    n_sets = math.ceil(3 * L2_BYTES / set_bytes)
    sets = [flash_inputs(B, S, S, H, KV, hd, torch.bfloat16, 100 + i, dev) for i in range(n_sets)]
    tc0 = FA.flash_attention_bhsd.tc_launches
    ms, out = device_ms([lambda x=x: ops.flash_attention(*x, True) for x in sets])
    check(FA.flash_attention_bhsd.tc_launches > tc0, "the timed flash calls did not take the "
          "tensor-core kernel")
    pms, pout = device_ms([lambda x=x: FA.attention_ref(*x, True) for x in sets])
    lms, lout = device_ms([lambda x=x: F.scaled_dot_product_attention(
        x[0].transpose(1, 2), x[1].transpose(1, 2), x[2].transpose(1, 2),
        is_causal=True, enable_gqa=True) for x in sets])
    attn_close(out, pout, "flash_attention_bhsd (timed) against its plain version")
    attn_close(out, lout.transpose(1, 2), "flash_attention_bhsd (timed) against sdpa")
    ops_f = 4 * hd * B * H * S * (S + 1) // 2
    t_ops, t_bytes = ops_f / PEAK_BF16_S * 1e3, set_bytes / PEAK_BYTES_S * 1e3
    timing["flash_attention_bhsd"] = {
        "ms": ms, "plain_ms": pms, "library_ms": lms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes", "ops": ops_f,
        "bytes": set_bytes, "input_sets": n_sets,
        "host_call_ms": eager_ms(lambda: ops.flash_attention(*sets[0], True), 50),
        "shape": f"q ({B}, {S}, {H}, {hd}), k/v ({B}, {S}, {KV}, {hd}) bf16, causal",
        "variant": "tc",
    }
    del sets, out, pout, lout
    # decode: one decode step's 30 launches, each on its layer's cache, at
    # the middle position of the path's decode (1024 + 63)
    pos = PROMPT_LEN + GEN // 2 - 1
    g = torch.Generator(device=dev)
    g.manual_seed(30)
    layers = [tuple(torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                    for shape in ((B, 1, H, hd), (B, max_seq, KV, hd), (B, max_seq, KV, hd)))
              for _ in range(L)]
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    ms, out = device_ms([lambda x=x: ops.decode_attention(*x, p) for x in layers])
    pms, pout = device_ms([lambda x=x: DA.attention_ref(x[0][:, 0], x[1], x[2], p) for x in layers])
    lms, lout = device_ms([lambda x=x: F.scaled_dot_product_attention(
        x[0].transpose(1, 2), x[1][:, :pos + 1].transpose(1, 2), x[2][:, :pos + 1].transpose(1, 2),
        enable_gqa=True) for x in layers])
    attn_close(out, pout.unsqueeze(1), "decode_attention_bhd (timed) against its plain version")
    attn_close(out, lout.transpose(1, 2), "decode_attention_bhd (timed) against sdpa")
    dk = device_kernels(lambda: ops.decode_attention(*layers[0], p),
                        ("decode_split_kernel", "decode_combine_kernel"))
    check(all(n == 1 for n in dk.values()), f"one decode call ran the device kernels {dk}")
    d_bytes = 2 * B * (pos + 1) * KV * hd * 2 + 2 * B * H * hd * 2 + 4
    d_ops = 4 * hd * B * H * (pos + 1)
    t_ops, t_bytes = d_ops / PEAK_BF16_S * 1e3, d_bytes / PEAK_BYTES_S * 1e3
    timing["decode_attention_bhd"] = {
        "ms": ms, "plain_ms": pms, "library_ms": lms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops > t_bytes else "bytes", "ops": d_ops,
        "bytes": d_bytes, "pos": pos, "launch_floor_ms": launch_floor_ms,
        "host_call_ms": eager_ms(lambda: ops.decode_attention(*layers[0], p), 200),
        "shape": f"q ({B}, 1, {H}, {hd}), cache ({B}, {max_seq}, {KV}, {hd}) bf16, pos {pos}",
        "device_kernels": sum(dk.values()), "device_kernels_by_name": dk,
        "split_rows": DA.SPLIT_ROWS, "splits": DA.split_count(max_seq),
    }
    del layers, out, pout, lout
    # one whole decode step of the path, replayed as a CUDA graph (device
    # time, no host), against the same step issued eagerly
    m = LanguageModel(cfg)
    _, cache = m.prefill(params, prompts, max_seq)
    tok = torch.zeros((REQUESTS, 1), dtype=torch.int32, device=dev)
    step_eager = eager_ms(lambda: m.decode_step(params, cache, tok), 20)
    cache["pos"].fill_(PROMPT_LEN)
    step_graph, _ = device_ms([lambda: m.decode_step(params, cache, tok)], samples=20)
    del cache
    emit("serve_timing", seconds=time.monotonic() - t0, times=timing,
         decode_step={"graph_ms": step_graph, "eager_ms": step_eager,
                      "device_idle_share_eager": 1.0 - step_graph / step_eager,
                      "note": "one decode step of the 30-layer model: replayed as a CUDA "
                              "graph (device time) and issued eagerly from Python"},
         note="device_ms: CUDA graph of the calls, median of replays; flash over input "
              "sets 3x the L2, decode over the 30 layers' caches (214 MB)")

    kernels = []
    for name, t in timing.items():
        extra = ({"variant": t["variant"]} if name == "flash_attention_bhsd" else
                 {"device_kernels": t["device_kernels"], "split_rows": t["split_rows"]})
        kernels.append({
            "name": name, "route": "cuda", "source": ATTN_SOURCE.format(name.rsplit("_", 1)[0]),
            "replaces": ATTN_REPLACES[name], "launches": launches[name],
            "max_abs_err": err[name], **{k: t[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "host_call_ms": t["host_call_ms"], "shape": t["shape"], **extra,
        })
    return kernels


# --------------------------------------------------------------------------- #
# The RWKV6 serving path
# --------------------------------------------------------------------------- #
def wkv_close(got, want, what: str) -> float:
    """Hold the WKV kernel's ``(y, sT)`` to its plain version's: the final
    state bit for bit, y within WKV_Y_TOL of max|y|.  Returns y's largest
    absolute error."""
    import torch

    (y, s), (yw, sw) = got, want
    torch.cuda.synchronize()
    check(y.shape == yw.shape and s.shape == sw.shape and y.dtype == yw.dtype == torch.float32,
          f"{what}: y {tuple(y.shape)} / state {tuple(s.shape)} against {tuple(yw.shape)} / "
          f"{tuple(sw.shape)}")
    check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all()),
          f"{what}: non-finite output")
    differ = int((s.view(torch.int32) != sw.view(torch.int32)).sum())
    check(differ == 0, f"{what}: {differ} state entries differ from the plain version's "
          f"(max {float((s - sw).abs().max())})")
    err, scale = float((y - yw).abs().max()), float(yw.abs().max())
    check(err <= WKV_Y_TOL * scale, f"{what}: y off by {err} (max|y| {scale})")
    return err


def wkv_bound(B: int, S: int, H: int, hd: int, with_s0: bool) -> dict:
    """Least time of one launch: r, k, v, w read and y written (f32), u
    read per head, the final state written and, given one, the initial
    state read; against the f32 operations of the recurrence."""
    nbytes = 4 * (5 * B * S * H * hd + H * hd + (2 if with_s0 else 1) * B * H * hd * hd)
    nops = B * S * H * (WKV_OPS_HD2 * hd * hd + WKV_OPS_HD * hd)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, nops / PEAK_F32_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else
            "operations", "bytes": nbytes, "ops": nops, "bytes_ms": t_bytes, "ops_ms": t_ops}


def rwkv_products_ms(params, cfg, rows: int, head_rows: int, dev) -> float:
    """Device time of the matrix products of one pass of the RWKV model
    over ``rows`` tokens (the LM head over ``head_rows``): the same bf16
    weights, random activations of the products' shapes, every product
    into a buffer of its shape, all of them replayed as one CUDA graph."""
    import torch

    D, lora = cfg.d_model, cfg.ssm.decay_lora
    g = torch.Generator(device=dev)
    g.manual_seed(60)

    def act(n):
        return torch.randn((rows, n), generator=g, device=dev).to(torch.bfloat16)

    xs = {D: act(D), cfg.d_ff: act(cfg.d_ff), lora: act(lora)}
    outs = {}

    def product(x, w):
        o = outs.setdefault((x.shape[0], w.shape[1]), torch.empty(
            (x.shape[0], w.shape[1]), dtype=torch.bfloat16, device=dev))
        return lambda: torch.mm(x, w, out=o)

    calls = []
    for blk in params["blocks"]:
        mix, mlp = blk["mixer"], blk["mlp"]
        for r in range(cfg.n_repeats):
            mats = [mix[n][r].reshape(D, -1) for n in ("wr", "wk", "wv", "wg")]
            mats += [mix["w_lora_a"][r], mix["w_lora_b"][r].reshape(lora, -1),
                     mix["wo"][r].reshape(-1, D), mlp["wk"][r], mlp["wv"][r], mlp["wr"][r]]
            calls += [product(xs[w.shape[0]], w) for w in mats]
    calls.append(product(xs[D][:head_rows], params["lm_head"]))
    ms, _ = device_ms(calls)
    return ms * len(calls)


def rwkv_phases(dev, wkv_regs: dict) -> list:
    """Phases 15-18: the WKV kernel against its plain version, the RWKV
    model on the card against the port on the CPU, the RWKV6-7B serving
    path, and the kernel's times (``wkv_regs``: the build's register
    report of its instantiations).  Returns the kernel's entry of the
    ``kernels`` line."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.checkpoint.store import flatten_with_keys, map_with_keys
    from repro_torch.configs import get
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6 as W
    from repro_torch.launch.serve import fault_trace, serve
    from repro_torch.models import LanguageModel, RuntimeFlags

    cfg = get("rwkv6-7b")
    L, H, hd = cfg.num_layers, cfg.rwkv_heads, cfg.ssm.rwkv_head_dim
    B, S = REQUESTS, PROMPT_LEN
    max_seq = PROMPT_LEN + GEN + 8

    # ---- 15. the kernel against its plain version ---------------------- #
    # the path's prefill (zero initial state) and decode shapes, then the
    # other head dims, one (batch, head) pair over a long sequence, decays
    # near 0 and 1, the reference's (BH, S, hd) layout, strided views
    t0 = time.monotonic()
    cases, y_err = [], 0.0

    def case(name, got, want, **info):
        nonlocal y_err
        e = wkv_close(got, want, f"wkv6_bhsd/{name}")
        y_err = max(y_err, e)
        cases.append({"case": name, "y_max_abs_err": e, "y_max_abs": float(want[0].abs().max()),
                      "state_bit_equal": True, **info})

    for name, b, s_, h, d, w_range, zero_s0 in (
        ("prefill", B, S, H, hd, (0.001, 0.9999), True),
        ("decode", B, 1, H, hd, (0.001, 0.9999), False),
        ("hd16", 2, 333, 3, 16, (0.001, 0.9999), False),
        ("hd32", 2, 1000, 3, 32, (0.001, 0.9999), False),
        ("hd128", 2, 333, 3, 128, (0.001, 0.9999), False),
        ("bh1_s2000", 1, 2000, 1, hd, (0.001, 0.9999), False),
        ("w_near_0", 2, 600, 4, hd, (1e-6, 1e-3), False),
        ("w_near_1", 2, 600, 4, hd, (0.999, 0.9999), False),
    ):
        x = W.sample_wkv_inputs(b, s_, h, d, seed=len(cases), device=dev, w_range=w_range)
        if zero_s0:
            x = x[:5]
        case(name, ops.wkv6(*x), W.wkv_ref(*x), shape=[b, s_, h, d], w_range=list(w_range),
             s0=not zero_s0)
    # the serving cache's decode, the state written in place: the path's
    # shape, then the one-token kernel at the other head dims
    for name, b, h, d in (("decode_in_place", B, H, hd), ("decode_in_place_hd16", 4, 8, 16),
                          ("decode_in_place_hd32", 4, 8, 32),
                          ("decode_in_place_hd128", 4, 8, 128)):
        r, k, v, w, u, s0 = W.sample_wkv_inputs(b, 1, h, d, seed=20 + d, device=dev)
        want = W.wkv_ref(r, k, v, w, u, s0)
        state = s0.clone()
        got = ops.wkv6(r, k, v, w, u, state, state_out=state)
        check(got[1] is state, "state_out was not the returned state")
        case(name, got, want, shape=[b, 1, h, d])
    # more (batch, head) blocks than the card holds at once (B 16 x H 64)
    for name, s_ in (("two_waves_prefill", 48), ("two_waves_decode", 1)):
        x = W.sample_wkv_inputs(16, s_, H, hd, seed=30 + s_, device=dev)
        case(name, ops.wkv6(*x), W.wkv_ref(*x), shape=[16, s_, H, hd])
    r, k, v, w, u, s0 = W.sample_wkv_inputs(4, 300, 3, hd, seed=21, device=dev)
    flat = [t.transpose(1, 2).reshape(12, 300, hd).contiguous() for t in (r, k, v, w)]
    ub = u.expand(4, 3, hd).reshape(12, hd).contiguous()
    case("bhsd_layout", W.wkv6_bhsd(*flat, ub, s0.reshape(12, hd, hd)),
         W.wkv6_ref(*flat, ub, s0.reshape(12, hd, hd)), shape=[12, 300, hd])
    big = torch.zeros((4, 4, 300, 5, hd), device=dev)
    for i, t in enumerate((r, k, v, w)):
        big[i, :, :, 2:] = t
    case("strided_views", ops.wkv6(*(big[i, :, :, 2:] for i in range(4)), u, s0),
         W.wkv_ref(r, k, v, w, u, s0), shape=[4, 300, 3, hd])
    del big, flat, x
    emit("wkv_check", seconds=time.monotonic() - t0, cases=cases, y_tol_of_max=WKV_Y_TOL,
         state="bit-equal to the plain version in every case")

    # ---- 16. the RWKV model on the card against the port on the CPU ---- #
    # (full width, 2 layers, f32; the bonus u, the decays w0, the token-shift
    # lerps mu and the group-norm scale ln drawn from a seed, with the CPU
    # tests' laws, since the init leaves them zero or constant; the CPU side
    # on one thread)
    t0 = time.monotonic()
    small = dataclasses.replace(cfg, num_layers=2)
    flags = RuntimeFlags(compute_dtype=torch.float32)
    m_cpu, m_gpu = LanguageModel(small, flags), LanguageModel(small, flags)
    p_cpu = m_cpu.init(torch.Generator().manual_seed(SERVE_SEED))
    g = torch.Generator().manual_seed(SERVE_SEED + 1)
    mix, cmix = p_cpu["blocks"][0]["mixer"], p_cpu["blocks"][0]["mlp"]
    mix["u"] = torch.randn(mix["u"].shape, generator=g) * 0.5
    mix["w0"] = torch.rand(mix["w0"].shape, generator=g) * 6 - 5
    mix["mu"] = torch.rand(mix["mu"].shape, generator=g)
    mix["ln"] = 1 + 0.1 * torch.randn(mix["ln"].shape, generator=g)
    cmix["mu"] = torch.rand(cmix["mu"].shape, generator=g)
    p_gpu = map_with_keys(lambda _, x: x.to(dev), p_cpu)
    cpu_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    toks = torch.from_numpy(np.random.default_rng(SERVE_SEED).integers(
        0, small.vocab_size, (2, 128)).astype(np.int32))
    lc, cc = m_cpu.prefill(p_cpu, toks, 128 + 16)
    lg, cg = m_gpu.prefill(p_gpu, toks.to(dev), 128 + 16)
    diffs = {"prefill": float((lg.cpu() - lc).abs().max()), "decode_same_cache": 0.0,
             "decode_own_cache": 0.0}
    state_diff = float((cg["blocks"][0]["state"].cpu() - cc["blocks"][0]["state"]).abs().max())
    same_tokens = True
    tok = lc[:, -1].argmax(-1).to(torch.int32)[:, None]
    for _ in range(8):
        synced = map_with_keys(lambda _, x: x.to(dev, copy=True), cc)
        ls, _ = m_gpu.decode_step(p_gpu, synced, tok.to(dev))
        lc, cc = m_cpu.decode_step(p_cpu, cc, tok)
        lg, cg = m_gpu.decode_step(p_gpu, cg, tok.to(dev))
        diffs["decode_same_cache"] = max(diffs["decode_same_cache"],
                                         float((ls.cpu() - lc).abs().max()))
        diffs["decode_own_cache"] = max(diffs["decode_own_cache"],
                                        float((lg.cpu() - lc).abs().max()))
        same_tokens &= bool(torch.equal(lg.cpu().argmax(-1), lc.argmax(-1)))
        tok = lc[:, -1].argmax(-1).to(torch.int32)[:, None]
    torch.set_num_threads(cpu_threads)
    check(bool(torch.isfinite(lg).all()), "card logits not finite")
    for k_, tol in RWKV_CARD_CPU_TOL.items():
        check(diffs[k_] <= tol, f"RWKV card vs CPU: {k_} logits differ by {diffs[k_]} > {tol}")
    emit("rwkv_card_vs_cpu", seconds=time.monotonic() - t0, layers=2, d_model=small.d_model,
         heads=H, head_dim=hd, d_ff=small.d_ff, vocab=small.vocab_size, batch=2, prompt=128,
         decode_steps=8, compute="float32", max_abs_logit=float(lc.abs().max()),
         max_abs_diff=diffs, prefill_state_max_abs_diff=state_diff, tol=RWKV_CARD_CPU_TOL,
         greedy_tokens_equal=same_tokens)
    del m_cpu, m_gpu, p_cpu, p_gpu, cc, cg, synced, mix, cmix

    # ---- 17. the path: serve RWKV6-7B, without and with faults --------- #
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kw = dict(requests=REQUESTS, prompt_len=PROMPT_LEN, gen=GEN,
              snapshot_every=SNAPSHOT_EVERY, seed=SERVE_SEED, device=dev)
    W.wkv6_bhsd.launches = 0
    torch.cuda.synchronize()
    clean = serve(cfg, **kw)
    n_clean = W.wkv6_bhsd.launches
    check(clean["decode_steps"] == GEN - 1, f"fault-free run took {clean['decode_steps']} steps")
    check(n_clean == L * (1 + clean["decode_steps"]),
          f"wkv6_bhsd launched {n_clean} times for one prefill and {clean['decode_steps']} "
          f"decode steps of {L} layers")
    toks_clean = clean["tokens"]
    check(tuple(toks_clean.shape) == (REQUESTS, GEN), f"tokens {tuple(toks_clean.shape)}")
    check(bool(((toks_clean >= 0) & (toks_clean < cfg.vocab_size)).all()), "token out of range")

    mtbf = clean["decode_s"] / 4
    times = fault_trace(SERVE_SEED, mtbf)[:MAX_FAULTS]
    W.wkv6_bhsd.launches = 0
    faulted = serve(cfg, fault_times=times, **kw)
    n_faulted = W.wkv6_bhsd.launches
    check(faulted["faults"] >= 1, "no fault landed in the faulted run")
    check(torch.equal(faulted["tokens"], toks_clean),
          f"faulted run's tokens differ from the fault-free run's in "
          f"{int((faulted['tokens'] != toks_clean).sum())} places")
    check(faulted["decode_steps"] == GEN - 1 + faulted["redecoded"], "replayed steps miscounted")
    check(n_faulted == L * (1 + faulted["decode_steps"]),
          f"faulted run launched wkv6_bhsd {n_faulted} times for {faulted['decode_steps']} steps")
    serve_peak = torch.cuda.max_memory_allocated()

    # one prefill and one decode step of the same model, counted apart;
    # then one decode step replayed as a CUDA graph against the same step
    # issued eagerly
    g = torch.Generator(device=dev)
    g.manual_seed(SERVE_SEED)
    m = LanguageModel(cfg)
    params = m.cast_params(m.init(g))
    prompts = torch.from_numpy(np.random.default_rng(SERVE_SEED).integers(
        0, cfg.vocab_size, (REQUESTS, PROMPT_LEN)).astype(np.int32)).to(dev)
    W.wkv6_bhsd.launches = 0
    logits, cache = m.prefill(params, prompts, max_seq)
    torch.cuda.synchronize()
    n_prefill = W.wkv6_bhsd.launches
    check(n_prefill == L, f"one prefill launched wkv6_bhsd {n_prefill} times")
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    check(torch.equal(tok[:, 0].cpu(), toks_clean[:, 0]),
          "the model's prefill greedy tokens are not serve()'s first tokens")
    W.wkv6_bhsd.launches = 0
    logits, cache = m.decode_step(params, cache, tok)
    torch.cuda.synchronize()
    n_step = W.wkv6_bhsd.launches
    check(n_step == L, f"one decode step launched wkv6_bhsd {n_step} times")
    check(torch.equal(logits[:, -1].argmax(-1).to(torch.int32).cpu(), toks_clean[:, 1]),
          "the model's first decode step's tokens are not serve()'s second tokens")
    step_eager = eager_ms(lambda: m.decode_step(params, cache, tok), 20)
    step_graph, _ = device_ms([lambda: m.decode_step(params, cache, tok)], samples=20)
    # the step's and the prefill's matrix products alone (the rest of the
    # device time is the WKV launches and the elementwise glue)
    products = {"decode_step_ms": rwkv_products_ms(params, cfg, REQUESTS, REQUESTS, dev),
                "prefill_ms": rwkv_products_ms(params, cfg, REQUESTS * PROMPT_LEN, REQUESTS, dev)}
    weight_bytes = sum(x.numel() * x.element_size()
                       for key, x in flatten_with_keys(params).items() if key != "embed")
    state_bytes = sum(b["state"].numel() * 4 for b in cache["blocks"])
    floor_ms = (weight_bytes + 2 * state_bytes) / PEAK_BYTES_S * 1e3
    peak = torch.cuda.max_memory_allocated()
    del params, cache, logits, m
    torch.cuda.empty_cache()
    steps_ms = clean["decode_s"] * 1e3 / clean["decode_steps"]
    emit("rwkv_serve", model=cfg.name, layers=L, params=cfg.param_count(), compute="bfloat16",
         requests=REQUESTS, prompt_len=PROMPT_LEN, gen=GEN, snapshot_every=SNAPSHOT_EVERY,
         prefill_s=clean["prefill_s"], decode_s=clean["decode_s"],
         decode_ms_per_token=steps_ms, tokens_per_s=REQUESTS * GEN / clean["wall_s"],
         wall_s=clean["wall_s"],
         launches={"serve": n_clean, "prefill": n_prefill, "decode_step": n_step},
         faulted={"mtbf_s": mtbf, "fault_times_s": times, "faults": faulted["faults"],
                  "redecoded": faulted["redecoded"], "decode_steps": faulted["decode_steps"],
                  "wall_s": faulted["wall_s"], "decode_s": faulted["decode_s"],
                  "launches": n_faulted, "tokens_equal_fault_free": True},
         decode_step={"graph_ms": step_graph, "eager_ms": step_eager,
                      "device_idle_share_eager": 1.0 - step_graph / step_eager,
                      "weight_bytes": weight_bytes, "state_cache_bytes": state_bytes,
                      "floor_ms": floor_ms, "products_ms": products["decode_step_ms"],
                      "note": f"one decode step of the {L}-layer model: replayed as a CUDA "
                              "graph (device time) and issued eagerly from Python; the floor "
                              "reads the weights (all but the embedding table) once and reads "
                              "and writes the state cache; products_ms: its matrix "
                              "products alone, replayed as a CUDA graph"},
         prefill_products_ms=products["prefill_ms"],
         max_memory_allocated_bytes={"serve": serve_peak, "phase": peak},
         nvidia_smi=subprocess.run(
             ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
             capture_output=True, text=True, check=True).stdout.strip())

    # ---- 18. times at the path's shapes -------------------------------- #
    # prefill: one layer's launch, zero initial state (537 MB of inputs, 10x
    # the L2); decode: one decode step's 32 launches, each on its own
    # layer's state (268 MB in all), the final state into another buffer so
    # every replay does the same work; each at the default tile and at the
    # other built one.  The SM clock is sampled while the default prefill
    # is replayed, for the issue floor.
    t0 = time.monotonic()
    r, k, v, w, u = W.sample_wkv_inputs(B, S, H, hd, seed=40, device=dev)[:5]
    clocks = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits", "-lms", "20"],
        stdout=subprocess.PIPE, text=True)
    try:
        clocks.stdout.readline()  # the sampler runs (its first, idle, sample is dropped)
        ms, out = device_ms([lambda: ops.wkv6(r, k, v, w, u)], samples=1000)
    finally:
        clocks.terminate()
        mhz = [int(x) for x in clocks.communicate()[0].split() if x.isdigit()]
    pms, pout = device_ms([lambda: W.wkv_ref(r, k, v, w, u)])
    wkv_close(out, pout, "wkv6_bhsd (timed prefill) against its plain version")
    other_ms, out = device_ms([lambda: ops.wkv6(r, k, v, w, u,
                                                tile_rows=WKV_OTHER_TILE["prefill"])])
    wkv_close(out, pout, "wkv6_bhsd (timed prefill, other tile) against its plain version")
    check(len(mhz) > 0, "nvidia-smi read no SM clock during the timed prefill")
    mhz_med = sorted(mhz)[len(mhz) // 2]
    updates = B * S * H * hd * hd
    issue_floor = WKV_ISSUE_PER_ENTRY * updates / (SMS * F32_LANES * mhz_med * 1e6) * 1e3
    prefill_t = {"ms": ms, "plain_ms": pms, **wkv_bound(B, S, H, hd, with_s0=False),
                 "issue_floor_ms": issue_floor, "entry_updates": updates,
                 "sm_clock_mhz": {"median": mhz_med, "min": min(mhz), "max": max(mhz),
                                  "samples": len(mhz)},
                 "tile_rows": WKV_TILES["prefill"],
                 "other_tile": {"tile_rows": WKV_OTHER_TILE["prefill"], "ms": other_ms}}
    del r, k, v, w, out, pout
    layers = [W.sample_wkv_inputs(B, 1, H, hd, seed=50 + i, device=dev) for i in range(L)]
    outs = [torch.empty_like(x[5]) for x in layers]
    ms, out = device_ms([lambda x=x, o=o: ops.wkv6(*x, state_out=o)
                         for x, o in zip(layers, outs)])
    pms, pout = device_ms([lambda x=x: W.wkv_ref(*x) for x in layers])
    wkv_close(out, pout, "wkv6_bhsd (timed decode) against its plain version")
    other_ms, out = device_ms([lambda x=x, o=o: ops.wkv6(
        *x, state_out=o, tile_rows=WKV_OTHER_TILE["decode"]) for x, o in zip(layers, outs)])
    wkv_close(out, pout, "wkv6_bhsd (timed decode, other tile) against its plain version")
    decode_t = {"ms": ms, "plain_ms": pms, **wkv_bound(B, 1, H, hd, with_s0=True),
                "host_call_ms": eager_ms(lambda: ops.wkv6(*layers[0], state_out=outs[0]), 200),
                "tile_rows": WKV_TILES["decode"],
                "other_tile": {"tile_rows": WKV_OTHER_TILE["decode"], "ms": other_ms}}
    del layers, outs, out, pout
    # the launch floor: one (batch, head) pair, one token, 32 launches a graph
    tiny = W.sample_wkv_inputs(1, 1, 1, hd, seed=60, device=dev)
    tiny_out = torch.empty_like(tiny[5])
    launch_floor, _ = device_ms([lambda: ops.wkv6(*tiny, state_out=tiny_out)] * L)
    emit("wkv_timing", seconds=time.monotonic() - t0, prefill=prefill_t, decode=decode_t,
         launch_floor_ms=launch_floor, registers=wkv_regs,
         launches_on_path={"prefill": n_prefill, "decode_step": n_step, "serve": n_clean},
         library_ms=None,
         note="device_ms: CUDA graph of the calls, median of replays; issue_floor_ms: "
              f"{WKV_ISSUE_PER_ENTRY} f32 instructions an entry update over {SMS} x "
              f"{F32_LANES} lanes at the median SM clock nvidia-smi read during the timed "
              "prefill; launch_floor_ms: a one-pair, one-token launch, 32 to a graph; no "
              "single PyTorch call computes WKV6")
    return [{
        "name": "wkv6_bhsd", "route": "cuda", "source": WKV_SOURCE, "replaces": WKV_REPLACES,
        "launches": n_clean, "max_abs_err": y_err,
        **{k_: prefill_t[k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by",
                                        "issue_floor_ms", "tile_rows", "other_tile")},
        "library_ms": None,
        "decode_ms": decode_t["ms"], "decode_plain_ms": decode_t["plain_ms"],
        "decode_bound_ms": decode_t["bound_ms"], "decode_bound_by": decode_t["bound_by"],
        "decode_tile_rows": decode_t["tile_rows"], "decode_other_tile": decode_t["other_tile"],
        "host_call_ms": decode_t["host_call_ms"], "launch_floor_ms": launch_floor,
        "registers": {name: x.get("registers") for name, x in wkv_regs.items()},
        "shape": f"r/k/v/w ({B}, {S}, {H}, {hd}) f32, zero initial state; decode "
                 f"({B}, 1, {H}, {hd}) over a ({B}, {H}, {hd}, {hd}) state",
    }]


# --------------------------------------------------------------------------- #
# The mixed-law sweep
# --------------------------------------------------------------------------- #
def mixed_grid(preset: str, n_runs: int):
    """The reference benchmark's mixed-law grid: the paper grid under the
    exponential, Weibull 0.7 and lognormal 0.5 laws, labels prefixed by
    the law, seed ``MIXED_SEED``."""
    from dataclasses import replace

    from repro_torch.core.events import lognormal, weibull
    from repro_torch.experiments import GridSpec, paper_grid_cells

    laws = (("exp", None), ("weibull", weibull(0.7)), ("lognormal", lognormal(0.5)))
    cells = [replace(c, label=f"{law}/{c.label}", fault_dist=d)
             for law, d in laws for c in paper_grid_cells(preset)]
    return GridSpec(tuple(cells), n_runs=n_runs, seed=MIXED_SEED), [law for law, _ in laws]


def sim_step_wrappers(K) -> tuple:
    return (K.masked_primitive_update, K.masked_stream_advance,
            K.masked_prediction_walk, K.masked_strike_walk, K.masked_silent_walk,
            K.masked_slab_prediction_skip, K.masked_slab_strike_walk,
            K.masked_slab_silent_walk)


#: each wrapper's launch counters: single-law, law-indexed, trace-fed
COUNTERS = (("", "launches"), ("[indexed]", "indexed_launches"), ("[host]", "host_launches"))


def counts(K) -> dict:
    return {f"{fn.__name__}{tag}": getattr(fn, attr)
            for fn in sim_step_wrappers(K) for tag, attr in COUNTERS if hasattr(fn, attr)}


def reset_counts(K) -> None:
    for fn in sim_step_wrappers(K):
        for _, attr in COUNTERS:
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def path_launches(launches: dict, meta: dict, suffix: str, max_cursor: float = 4.0) -> dict:
    """Phase 4 / 20 / 25's launch record: per kernel and per outer
    iteration, the cursor kernels together and the host syncs per
    iteration; fails unless the walks launched and the syncs and cursor
    launches per iteration are at most 1 and ``max_cursor`` (4: three
    walks an iteration and the chunk's priming; the silent walk is a
    fourth on the scenario path)."""
    iters = max(meta["outer_iters"], 1)
    for name in WALKS:
        check(launches[name + suffix] > 0, f"{name}{suffix} was not launched on the path")
    cursor = sum(launches[n + suffix] for n in CURSOR_KERNELS)
    syncs = meta["host_syncs"] / iters
    check(syncs <= 1.0, f"{syncs} host syncs per outer iteration")
    check(cursor / iters <= max_cursor, f"{cursor / iters} cursor launches per outer iteration")
    return {"launches_per_iter": {k: v / iters for k, v in launches.items() if v},
            "cursor_launches_per_iter": cursor / iters, "syncs_per_iter": syncs}


def mixed_law_phases(dev, regs: dict) -> list:
    """Phases 19-21: the law-indexed variant of the four sim_step kernels
    against its plain version (the walks on the mixed grid's own lanes) and
    the one-event kernels against the single-law launch, the mixed-law
    paper grid in one dispatch on the card, the card against the CPU and
    the fused dispatch against the per-family one; then the variant's
    times.  Returns its four entries of the ``kernels`` line."""
    import numpy as np
    import torch
    from repro_torch.experiments import run_grid
    from repro_torch.kernels import sim_step as K

    grid, law_names = mixed_grid("bench", RUNS_PER_CELL)
    L = grid.n_lanes

    def lanes(seed: int, block: int) -> dict:
        x = {**K.sample_lane_state(L, seed), **K.sample_lane_laws(L, seed + 1, block)}
        return K.lane_state_tensors(x, dev)

    # ---- 19. the indexed kernels against their plain versions ---------- #
    t0 = time.monotonic()
    x = lanes(200, 1)
    err = {"masked_primitive_update[indexed]": 0.0, "masked_stream_advance[indexed]": 0.0}
    got = {"prim": run_prim(K, x, "indexed", 0.0, False), "adv": run_adv(K, x, "indexed", 0.0, False)}
    want = {"prim": run_prim(K, x, "indexed", 0.0, True), "adv": run_adv(K, x, "indexed", 0.0, True)}
    ulps = {}
    for which, name in (("prim", "masked_primitive_update[indexed]"),
                        ("adv", "masked_stream_advance[indexed]")):
        for k, g in got[which].items():
            if k == "tm":
                ulps[name] = int(ulp_dist(g, want[which][k]).max())
                check(ulps[name] <= TM_ULPS, f"{name}: tm off by {ulps[name]} ulp")
            else:
                check(torch.equal(g, want[which][k]),
                      f"{name}: {k} differs from the plain version")
        err[name] = max_abs_err((g, want[which][k]) for k, g in got[which].items())
    faulted = got["prim"]["flags"].bitwise_and(1).ne(0)
    per_law = {}
    for li, (kind, param) in enumerate(K.SAMPLE_LAWS):
        on = x["pick"] == li
        check(bool((on & faulted).any()) and bool((on & x["mask"]).any()),
              f"{kind}({param}): no lane of this law drew")
        single = {"prim": run_prim(K, x, kind, param, False),
                  "adv": run_adv(K, x, kind, param, False)}
        for which in ("prim", "adv"):
            for k, g in got[which].items():
                check(torch.equal(g[on], single[which][k][on]),
                      f"{kind}({param}): indexed {which} {k} differs from the single-law "
                      "launch on this law's lanes")
        per_law[f"{kind}({param})"] = {"lanes": int(on.sum()),
                                       "faulted": int((on & faulted).sum())}
    # the law-indexed walks on the mixed grid's own lanes (iteration
    # CAPTURE_ITER), against their plain versions
    cap = capture_walks(grid, dev, CAPTURE_ITER)
    check(all(c.flat.get("f_law") is not None for n, c in cap.items() if n != "strike")
          and "law" in cap["strike"].flat, "the mixed grid's walks are not law-indexed")
    for n in WALKS:
        err[n + "[indexed]"] = 0.0
    for name, c in cap.items():
        wrapper = ("masked_strike_walk" if name == "strike" else "masked_prediction_walk") \
            + "[indexed]"
        u, e = walk_diff(walk_outputs(name, c.run(K)), walk_outputs(name, c.run(K, plain=True)),
                         f"{wrapper} {name}")
        ulps[f"{wrapper} {name}"] = u
        err[wrapper] = max(err[wrapper], e)
    torch.cuda.synchronize()
    emit("indexed_check", seconds=time.monotonic() - t0, lanes=L, tm_ulps=ulps,
         laws=per_law, walk_iteration=CAPTURE_ITER,
         compared="ctr, flags, t, saved, unsaved, pw equal to the plain "
         f"version, tm within {TM_ULPS} ulp; every output equal (0 ulp) to the single-law "
         "launch on each law's lanes; the walks on the mixed grid's lanes: counters equal, "
         f"dates within {TM_ULPS} ulp")

    # ---- 20. the mixed-law grid on the card, one dispatch -------------- #
    reset_counts(K)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    res = run_grid(grid, device="cuda")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = counts(K)
    meta = res.meta
    check(meta["device"].startswith("cuda"), f"mixed path ran on {meta['device']}")
    check(meta["dispatches"] == 1 and meta["n_chunks"] == 1 and meta["sampler"] == "indexed",
          f"mixed path: {meta}")
    for name, n in launches.items():
        if name.startswith(("masked_primitive_update", "masked_stream_advance")) \
                and name.endswith("[indexed]"):
            check(n > 0, f"{name} was not launched on the mixed-law path")
        elif not name.endswith("[indexed]"):
            check(n == 0, f"{name}: {n} single-law launches on the mixed-law path")
    check(meta["outer_iters"] == OUTER_ITERS["mixed"],
          f"{meta['outer_iters']} outer iterations, {OUTER_ITERS['mixed']} before the walks")
    per_iter = path_launches(launches, meta, "[indexed]")
    for c in res.cells:
        check(c.n_runs == RUNS_PER_CELL, f"{c.cell.label}: {c.n_runs} runs")
        check(0.0 < c.mean_waste < 1.0 and np.isfinite(c.ci95_waste),
              f"{c.cell.label}: waste {c.mean_waste}")
    anchors = {}
    for law in law_names:
        for pk in ("p82r85", "p40r70"):
            y = res[f"{law}/{pk}/N65536/Young"].mean_waste
            e = res[f"{law}/{pk}/N65536/Exact"].mean_waste
            if law == "exp":
                check(e < y, f"{law}/{pk}: ExactPrediction does not beat Young ({e} >= {y})")
            anchors[f"{law}/{pk}"] = {"Young": y, "Exact": e}
    emit("mixed_path", cells=len(res.cells), runs_per_cell=RUNS_PER_CELL, lanes=L,
         laws=law_names, seed=MIXED_SEED, seconds=wall, lanes_per_s=L / wall,
         outer_iters=meta["outer_iters"], host_syncs=meta["host_syncs"],
         dispatches=meta["dispatches"], n_chunks=meta["n_chunks"],
         launches={k: v for k, v in launches.items() if k.endswith("[indexed]")},
         **per_iter, waste_N65536=anchors)

    # ---- 21. card against CPU, fused against per-family --------------- #
    t0 = time.monotonic()
    val, _ = mixed_grid("validation", 8)
    worst = card_vs_cpu(run_grid(val, device="cuda"), run_grid(val, device="cpu"))
    fused = run_grid(val, device="cuda", collect="lanes")
    fam = run_grid(val, device="cuda", collect="lanes", dispatch="perfamily")
    check((fused.meta["dispatches"], fam.meta["dispatches"]) == (1, len(law_names)),
          f"dispatches: fused {fused.meta['dispatches']}, perfamily {fam.meta['dispatches']}")
    for a, b in zip(fused.cells, fam.cells):
        for f in ("makespan", "n_faults", "n_proactive_ckpts", "n_regular_ckpts",
                  "n_migrations"):
            check(np.array_equal(getattr(a, f), getattr(b, f)),
                  f"{a.cell.label}: {f} differs fused vs perfamily")
    emit("mixed_card_vs_cpu", seconds=time.monotonic() - t0, cells=len(val.cells),
         lanes=val.n_lanes, max_rel_float=worst, rtol=1e-9,
         fused_vs_perfamily="every lane bit-equal (makespan and counters)",
         dispatches={"fused": fused.meta["dispatches"], "perfamily": fam.meta["dispatches"]})

    # ---- times of the indexed variants at the mixed path's lane count -- #
    # The path's lanes come in runs of one cell (1000 lanes, one law); the
    # same lanes with laws mixed lane by lane, and each law's single-law
    # launch on them, show what the per-lane law costs.
    t0 = time.monotonic()
    xb = lanes(210, RUNS_PER_CELL)
    xm = dict(xb, **{k: v for k, v in lanes(210, 1).items() if k in ("pick", "law", "s1", "s2")})
    xs = {k: v[:128].clone() for k, v in xb.items()}
    want_prim = run_prim(K, xb, "indexed", 0.0, True)
    want_adv = run_adv(K, xb, "indexed", 0.0, True)
    n_fault = int(want_prim["flags"].bitwise_and(1).ne(0).sum())
    n_mask = int(xb["mask"].sum())

    timing = {}
    for name, call, want, nbytes, ops in (
        ("masked_primitive_update[indexed]", prim_call, want_prim,
         BYTES_PRIM * L + (BYTES_PRIM_FAULTED + BYTES_LAW) * n_fault,
         OPS_PRIM * L + OPS_GAP * n_fault),
        ("masked_stream_advance[indexed]", adv_call, want_adv,
         BYTES_ADV * L + (BYTES_ADV_MASKED + BYTES_LAW) * n_mask, OPS_GAP * n_mask),
    ):
        n_copies = math.ceil(3 * L2_BYTES / nbytes)
        single = {f"{k}({p})": timed(lambda c, k=k, p=p: call(K, c, k, p), xb, n_copies)
                  for k, p in K.SAMPLE_LAWS}
        timing[name] = {
            "ms": timed(lambda c: call(K, c, "indexed", 0.0), xb, n_copies, want, name),
            "lane_mixed_ms": timed(lambda c: call(K, c, "indexed", 0.0), xm, n_copies),
            "single_law_ms": single,
            "single_law_mean_ms": sum(single.values()) / len(single),
            "plain_ms": timed(lambda c: call(K, c, "indexed", 0.0, plain=True), xb,
                              n_copies, want, name + " (plain)"),
            "launch_floor_ms": timed(lambda c: call(K, c, "indexed", 0.0), xs, 64),
            "host_call_ms": eager_ms(
                call(K, {k: v.clone() for k, v in xb.items()}, "indexed", 0.0), 200),
            "bytes": nbytes, "ops": ops, "copies": n_copies,
        }
    emit("indexed_timing", seconds=time.monotonic() - t0, lanes=L, faulted_lanes=n_fault,
         masked_lanes=n_mask, times=timing,
         note="device_ms over input copies restored before each replay; ms: laws in runs "
              "of 1000 lanes (the path's cells); lane_mixed_ms: a law per lane; "
              "single_law_ms: each law's single-law launch on the same lanes")
    t0 = time.monotonic()
    walk_times = time_walks(K, cap, None, True, "mixed path")
    emit("indexed_walk_timing", seconds=time.monotonic() - t0, lanes=L,
         iteration=CAPTURE_ITER, times=walk_times,
         registers={n + "[indexed]": regs.get(n + "[indexed]") for n in WALKS},
         note="the mixed grid's captured iteration, laws per cell as on the path; "
              "ms: device_ms over restored copies; plain_ms: eager, CUDA events")
    replaces = {"masked_primitive_update[indexed]": "src/repro/kernels/sim_step.py:516",
                "masked_stream_advance[indexed]": REPLACES_ADV}
    return [sim_step_entry(name, replaces[name], tm, launches[name], err[name],
                           lane_mixed_ms=tm["lane_mixed_ms"],
                           single_law_mean_ms=tm["single_law_mean_ms"],
                           lanes=L, faulted_lanes=n_fault, masked_lanes=n_mask,
                           registers=regs.get(name))
            for name, tm in timing.items()] + walk_entries(
                walk_times, launches, err, regs, "[indexed]", lanes=L,
                iteration=CAPTURE_ITER)


# --------------------------------------------------------------------------- #
# The paper's Section 5 check: optimal periods and validation
# --------------------------------------------------------------------------- #
def analytic_phases(dev, res, smi: str) -> None:
    """Phases 22-23: the batched Newton solve of the optimal periods on the
    card (against the CPU, the host period scan and the closed-form
    extremizer; timed on a 65,536-cell table), then the Holm-controlled
    validation of simulated grids against the analytic models: the
    validation grid at 200 runs a cell, and the main path's own sweep
    ``res`` (phase 4)."""
    import csv
    from dataclasses import replace

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import analytic as A
    from repro_torch.core import optimize
    from repro_torch.core.simulator import PERIOD_GRID
    from repro_torch.core.waste import i_prime
    from repro_torch.experiments import (
        GridSpec, paper_grid_cells, paper_policy_table, run_grid, validate_sweep,
        write_z_table,
    )
    from repro_torch.kernels import analytic as KA

    # ---- 22. the batched Newton solve ---------------------------------- #
    t0 = time.monotonic()
    cells = paper_grid_cells("full")
    tabs = A.tables_from_cells(cells)
    card = A.newton_optimize_tables(tabs, device="cuda")
    host = A.newton_optimize_tables(tabs, device="cpu")
    ulps, rel = {}, {}
    for k, g in card.items():
        c = host[k]
        check(np.isfinite(g).all(), f"newton {k}: non-finite on the card")
        rel[k] = float(np.max(np.abs(g - c) / np.maximum(np.abs(c), 1e-300)))
        ulps[k] = int(ulp_dist(torch.from_numpy(g), torch.from_numpy(c)).max())
        check(rel[k] <= NEWTON_RTOL, f"newton {k}: card vs CPU rel {rel[k]} > {NEWTON_RTOL}")
    pol = paper_policy_table("full")
    for k in ("T_R", "q", "waste"):
        check(np.array_equal(getattr(pol, k), card[k]),
              f"paper_policy_table('full').{k} differs from the card's solve")
    scan = [replace(c, strategy=replace(c.strategy, T_R=max(1.01 * c.platform.C,
                                                            m * c.strategy.T_R)))
            for c in cells for m in PERIOD_GRID]
    best = np.minimum(A.analytic_waste_cells(scan), 1.0).reshape(len(cells), -1).min(1)
    excess = float((card["waste"] - best).max())
    check(excess <= NEWTON_EXCESS_MAX,
          f"newton waste exceeds the host period scan's best by {excess}")
    te = A.analytic_period_cells(cells)
    # NoCkptI / WithCkptI cells past the validity clamp (I' >= mu_P: the
    # platform sits in proactive mode for good) have a waste flat in T_R,
    # so no extremizer to agree with
    flat = np.array([c.strategy.mode in ("nockpt", "withckpt") and c.predictor.recall > 0
                     and i_prime(c.strategy.q, c.predictor.precision, c.predictor.window,
                                 c.predictor.e_f) >= c.predictor.mu_p(c.platform.mu)
                     for c in cells])
    smooth = ((tabs["q_eff"] > 0.0) & (tabs["recall"] > 0.0) & (card["q"] == tabs["q_eff"])
              & ~((tabs["mode"] == 1) & (tabs["window"] > 0.0)) & ~flat)
    ext = float(np.max(np.abs(card["T_R"][smooth] - te[smooth]) / te[smooth]))
    check(smooth.sum() > 0 and ext <= EXTREMIZER_RTOL,
          f"newton T_R vs the closed-form extremizer: rel {ext} > {EXTREMIZER_RTOL}")

    # the calls users make, end to end on the card and on the CPU (wall
    # time, median of 5 after a warm-up): the paper grid's policy table
    # (108 cells, 128 rows) and one platform's best policy (its candidate
    # families, 8 rows)
    win = next(c for c in cells if c.predictor.window > 0.0)
    calls = {
        "paper_policy_table_full": lambda d: paper_policy_table("full", device=d),
        "optimize_best_one_platform": lambda d: optimize(
            "best", win.platform, win.predictor, method="newton", device=d),
    }

    def wall_s(fn, reps: int = 5) -> float:
        fn()
        ts = []
        for _ in range(reps):
            tc = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - tc)
        return sorted(ts)[reps // 2]

    user_calls = {name: {"card_s": wall_s(lambda: fn("cuda")), "cpu_s": wall_s(lambda: fn("cpu"))}
                  for name, fn in calls.items()}
    one = [calls["optimize_best_one_platform"](d) for d in ("cuda", "cpu")]
    check(one[0].strategy == one[1].strategy and one[0].q == one[1].q
          and abs(one[0].T_R - one[1].T_R) <= NEWTON_RTOL * one[1].T_R
          and abs(one[0].waste - one[1].waste) <= NEWTON_RTOL * one[1].waste,
          f"optimize('best', method='newton'): card {one[0]} vs CPU {one[1]}")

    # the timed table: the full grid's rows repeated, each row's MTBF (and
    # false-prediction mean, so the precision stays) scaled by a seeded
    # factor in [0.5, 2]
    rng = np.random.default_rng(NEWTON_SEED)
    big = {k: np.resize(np.asarray(v), NEWTON_CELLS) for k, v in tabs.items()}
    scale = rng.uniform(0.5, 2.0, NEWTON_CELLS)
    big["mtbf"] = big["mtbf"] * scale
    big["fp_mean"] = big["fp_mean"] * scale
    args, n_big = A.newton_inputs(big, device=dev)
    KA.newton_policy(*args)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # any host sync in the solve raises
    try:
        out = KA.newton_policy(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ms = []
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(5):
        a.record()
        KA.newton_policy(*args)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    cargs, _ = A.newton_inputs(big, device="cpu")
    tc = time.perf_counter()
    cout = KA.newton_policy(*cargs)
    cpu_s = time.perf_counter() - tc
    big_rel = 0.0
    for g, c in zip(out, cout):
        g, c = g[:n_big].cpu().numpy(), c[:n_big].numpy()
        check(np.isfinite(g).all(), "newton (65,536 cells): non-finite on the card")
        big_rel = max(big_rel, float(np.max(np.abs(g - c) / np.maximum(np.abs(c), 1e-300))))
    check(big_rel <= NEWTON_RTOL, f"newton (65,536 cells): card vs CPU rel {big_rel}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        KA.newton_policy(*args)
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith(("Memcpy", "Memset"))]
    check(len(dev_events) > 0, "newton: the profiler saw no device kernel")

    # the bracket loop alone (the trusted rows' solve), as an eager loop
    # of NEWTON_ITERS iterations and as one eager iteration and its
    # replays (what the solve runs on the card): CUDA events, median of 3
    # after a warm-up, and the two must end on the same bits
    def bracket_loop(bargs, graph: bool):
        cols, lo, hi = tuple(bargs[:17]), bargs[17], bargs[19]
        ms, T = [], None
        for _ in range(4):
            T = torch.clamp(torch.sqrt(2.0 * cols[5] * cols[2]), lo, hi)
            lo_b, hi_b = lo.clone(), hi.clone()
            a.record()
            if graph:
                KA._replay_steps(cols, T, lo_b, hi_b)
            else:
                for _ in range(KA.NEWTON_ITERS):
                    KA._newton_step(cols, T, lo_b, hi_b)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        return sorted(ms[1:])[1], T

    loop_ms = {}
    for what, bargs in (("cells_108", A.newton_inputs(tabs, device=dev)[0]),
                        ("cells_65536", args)):
        eager_ms, t_eager = bracket_loop(bargs, graph=False)
        graph_ms, t_graph = bracket_loop(bargs, graph=True)
        check(same_bits(t_eager, t_graph), f"newton bracket loop ({what}): graph replay != eager loop")
        loop_ms[what] = {"eager_ms": eager_ms, "graph_ms": graph_ms}
    emit("newton_check", seconds=time.monotonic() - t0, cells=len(cells),
         padded_rows=max(8, 1 << (len(cells) - 1).bit_length()),
         card_vs_cpu_rel=rel, card_vs_cpu_ulps=ulps, rtol=NEWTON_RTOL,
         excess_waste_max=excess, excess_limit=NEWTON_EXCESS_MAX,
         extremizer_cells=int(smooth.sum()), extremizer_rel_max=ext,
         flat_cells=[c.label for c, f in zip(cells, flat) if f],
         extremizer_rtol=EXTREMIZER_RTOL, q1_cells=int((card["q"] > 0).sum()),
         timed_cells=NEWTON_CELLS, iters=KA.NEWTON_ITERS, card_ms=sorted(ms)[len(ms) // 2],
         card_ms_samples=ms, cpu_s=cpu_s, cpu_threads=torch.get_num_threads(),
         big_card_vs_cpu_rel=big_rel, device_kernels_per_solve=len(dev_events),
         distinct_kernels=len({e.name for e in dev_events}),
         host_syncs_in_solve=0, user_calls=user_calls, bracket_loop=loop_ms,
         nvidia_smi=smi,
         note="card_ms: CUDA events around one solve, median of 5 after a warm-up; "
              "cpu_s: one solve on the CPU; host_syncs_in_solve: the solve ran under "
              "torch.cuda.set_sync_debug_mode('error'); user_calls: wall seconds of "
              "the whole call, median of 5; bracket_loop: CUDA events, median of 3")

    # ---- 23. validation against the analytic models -------------------- #
    def summary(rows, fails, what):
        check(not fails, f"{what}: {len(fails)} Holm rejects: " + "; ".join(
            f"{r.label} sim={r.mean_sim:.5f} analytic={r.analytic:.5f} "
            f"margin={r.margin:.5f} z={r.z:.2f}" for r in fails))
        check(all(math.isfinite(r.z) for r in rows), f"{what}: a z is not finite")
        check(all(r.se_sim > 0 for r in rows), f"{what}: a cell has se_sim <= 0")
        near = sorted(rows, key=lambda r: r.z, reverse=True)[:3]
        return {"cells": len(rows), "rejects": len(fails), "z_max": near[0].z,
                "nearest": [{"label": r.label, "mean_sim": r.mean_sim,
                             "analytic": r.analytic, "delta": r.delta,
                             "margin": r.margin, "share_of_margin": abs(r.delta) / r.margin,
                             "se_sim": r.se_sim, "z": r.z} for r in near]}

    t0 = time.monotonic()
    val = GridSpec(tuple(paper_grid_cells("validation")), n_runs=VALIDATION_RUNS,
                   seed=VALIDATION_SEED)
    vres = run_grid(val, device="cuda")
    sweep_s = time.monotonic() - t0
    rows_a, fails_a = validate_sweep(vres, alpha=VALIDATION_ALPHA)
    check(len(rows_a) == 54, f"validation grid: {len(rows_a)} cells")
    contract = summary(rows_a, fails_a, "validation grid")
    t1 = time.monotonic()
    rows_b, fails_b = validate_sweep(res, alpha=VALIDATION_ALPHA)
    check(len(rows_b) == 108, f"main path: {len(rows_b)} cells")
    main = summary(rows_b, fails_b, "main path sweep")
    validate_s = time.monotonic() - t1
    with tempfile.TemporaryDirectory(prefix="ztable_") as tmp:
        csv_path, json_path = Path(tmp, "ztable.csv"), Path(tmp, "ztable.json")
        write_z_table(rows_b, csv_path, str(json_path))
        with open(csv_path) as f:
            back = list(csv.DictReader(f))
        payload = json.loads(json_path.read_text())
    check(len(back) == len(rows_b) and payload["n_cells"] == len(rows_b)
          and payload["n_rejected"] == 0, "z table: wrong row count")
    for got, r in zip(back, rows_b):
        check(got["label"] == r.label and float(got["z"]) == r.z
              and float(got["margin"]) == r.margin and got["reject"] == str(r.reject),
              f"z table: row {r.label} does not read back")
    emit("validation", alpha=VALIDATION_ALPHA, seconds=time.monotonic() - t0,
         contract={"grid": "validation", "runs_per_cell": VALIDATION_RUNS,
                   "seed": VALIDATION_SEED, "sweep_s": sweep_s,
                   "outer_iters": vres.meta["outer_iters"], **contract},
         main_path={"grid": "full", "runs_per_cell": RUNS_PER_CELL, "seed": 0,
                    "validate_s": validate_s, **main},
         z_table_rows=len(back))


# --------------------------------------------------------------------------- #
# The lane machine's other modes: two-level, silent errors, fractional trust
# --------------------------------------------------------------------------- #
def scenario_grid(preset: str, n_runs: int, seed: int, law=None):
    """The two-level + silent-error scenario grid (``preset`` "full": 48
    cells, the reference benchmark's two_level_silent_cells48 grid)."""
    from repro_torch.experiments import GridSpec, silent_grid_cells, two_level_grid_cells

    cells = (two_level_grid_cells(preset, fault_dist=law)
             + silent_grid_cells(preset, fault_dist=law))
    return GridSpec(tuple(cells), n_runs=n_runs, seed=seed)


def trust_grid(preset: str, n_runs: int):
    """The paper grid with every strategy but the untrusted baselines at
    fractional trust (q alternating over ``TRUST_QS``), seed 0."""
    from dataclasses import replace

    from repro_torch.experiments import GridSpec, paper_grid_cells

    cells = [c if c.strategy.mode == "none" else replace(
        c, strategy=replace(c.strategy, q=TRUST_QS[i % len(TRUST_QS)]))
        for i, c in enumerate(paper_grid_cells(preset))]
    return GridSpec(tuple(cells), n_runs=n_runs, seed=0)


def card_vs_cpu_modes(on_gpu, on_cpu) -> float:
    """:func:`card_vs_cpu` plus the disk-recovery and detection counts."""
    for a, b in zip(on_gpu.cells, on_cpu.cells):
        for k in ("mean_disk_recoveries", "mean_detections"):
            check(a.stats[k] == b.stats[k], f"{a.cell.label}: {k} differs card vs CPU")
    return card_vs_cpu(on_gpu, on_cpu)


def family_counts(res) -> dict:
    """Disk recoveries and detections summed per family of cells."""
    out = {}
    for fam in ("tl", "sil"):
        cs = [c for c in res.cells if c.cell.label.startswith(fam + "/")]
        out[fam] = {"cells": len(cs),
                    "disk_recoveries": sum(c.mean_disk_recoveries * c.n_runs for c in cs),
                    "detections": sum(c.mean_detections * c.n_runs for c in cs)}
    return out


def scenario_phases(dev, regs: dict, main_launches: dict) -> list:
    """Phases 24-25: the silent walk and the trust-coin prediction walk
    against their plain versions; the scenario grid (two-level and silent
    errors) on the card with its validation gate, under two laws fused
    against per family; the paper grid at fractional trust on the card
    against the CPU.  Returns the new entries of the ``kernels`` line."""
    import numpy as np
    import torch
    from repro_torch.experiments import run_grid, validate_sweep
    from repro_torch.kernels import sim_step as K

    full = scenario_grid("full", RUNS_PER_CELL, SCENARIO_SEED)
    L = full.n_lanes

    # ---- 24. the silent walk and the trust coins against plain --------- #
    t0 = time.monotonic()
    check(main_launches[SILENT] == 0 and main_launches[SILENT + "[indexed]"] == 0,
          "the main path launched the silent walk")
    err, ulps = {}, {}
    cap = capture_walks(full, dev, CAPTURE_ITER, silent=True)
    sc = cap["silent"]
    lane_laws = {k: torch.from_numpy(v).to(dev)
                 for k, v in K.sample_lane_laws(L, 121, RUNS_PER_CELL).items()}
    silent_work = {}
    for suffix, law in (("", None), ("[indexed]", ("indexed", lane_laws))):
        got = walk_outputs("silent", sc.run(K, law=law))
        want = walk_outputs("silent", sc.run(K, plain=True, law=law))
        ulps[SILENT + suffix], err[SILENT + suffix] = walk_diff(got, want, SILENT + suffix)
        check(same_bits(got["corrupt"].view(torch.int64), want["corrupt"].view(torch.int64)),
              f"{SILENT}{suffix}: corrupt differs from the plain version")
        silent_work[SILENT + suffix] = walk_work(sc, want, bool(suffix))
    check(silent_work[SILENT]["walking_lanes"] > 0, "the captured silent walk walks no lane")
    # the trust coins on sampled lanes (q_eff 0, 0.3, 0.5, 1; the q = 0
    # lanes walk to their stream's end)
    x = K.lane_state_tensors(K.sample_walk_state(L, 130), dev)
    laws = K.sample_lane_laws(L, 131, 1)
    for k in ("law", "s1", "s2"):
        x[k] = torch.from_numpy(laws[k]).to(dev)
    consts = ("f_key", "f_mean", "tc_key", "recall", "window", "fp_key", "fp_mean", "horizon")
    trust_calls = {}
    for suffix, gap in (("", ("exponential", 0.0)), ("[indexed]", ("indexed", 0.0))):
        lk = (dict(f_law=x["law"], f_lp=(x["s1"], x["s2"]), fp_law=x["law"],
                   fp_lp=(x["s1"], x["s2"])) if suffix else {})
        for mode in ("until", "refill"):
            kw = dict(f_gap=gap, fp_gap=gap, tt_key=x["tt_key"], ft_key=x["ft_key"],
                      q_eff=x["q_eff"], **lk)
            if mode == "until":
                args = (x["mask"], None)
                kw["until"] = (x["t"], x["lead_act"])
            else:
                args = (x["mask"], x["fp_mask"])
            c = WalkCall("skip" if mode == "until" else "pop",
                         args + tuple(x[k] for k in K.PREDICTION_CURSORS)
                         + tuple(x[k] for k in consts), kw)
            got = walk_outputs(c.name, c.run(K))
            want = walk_outputs(c.name, c.run(K, plain=True))
            name = f"masked_prediction_walk[trust]{suffix}"
            u, e = walk_diff(got, want, f"{name} {mode}")
            ulps[f"{name} {mode}"] = u
            err[name] = max(err.get(name, 0.0), e)
            trust_calls[f"{mode}{suffix}"] = walk_work(c, want, bool(suffix))
    torch.cuda.synchronize()
    emit("scenario_check", seconds=time.monotonic() - t0, lanes=L, iteration=CAPTURE_ITER,
         silent_work=silent_work, trust_work=trust_calls, ulps=ulps,
         main_path_silent_launches=main_launches[SILENT]
         + main_launches[SILENT + "[indexed]"],
         compared=f"silent walk on the scenario grid's iteration {CAPTURE_ITER} (single-law "
                  "and per-lane laws): counters and corrupt equal to the plain version, "
                  f"sf_time within {TM_ULPS} ulp; prediction walk with trust coins on "
                  f"{L} sampled lanes (q_eff 0, 0.3, 0.5, 1), both modes, both variants: "
                  f"counters equal, dates within {TM_ULPS} ulp")

    # ---- 25. the scenario grid on the card ----------------------------- #
    reset_counts(K)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    res = run_grid(full, device="cuda")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = counts(K)
    meta = res.meta
    check(meta["device"].startswith("cuda") and meta["n_chunks"] == 1
          and meta["sampler"] == "single-law", f"scenario path: {meta}")
    check(launches[SILENT] > 0, "the silent walk was not launched on the scenario path")
    per_iter = path_launches(launches, meta, "", max_cursor=5.0)
    for c in res.cells:
        check(c.n_runs == RUNS_PER_CELL and 0.0 < c.mean_waste < 1.0
              and np.isfinite(c.ci95_waste), f"{c.cell.label}: waste {c.mean_waste}")
    fams = family_counts(res)
    check(fams["tl"]["disk_recoveries"] > 0 and fams["sil"]["detections"] > 0,
          f"scenario path: {fams}")
    rows, fails = validate_sweep(res, alpha=VALIDATION_ALPHA)
    scen = {"grid": "full", "cells": len(res.cells), "runs_per_cell": RUNS_PER_CELL,
            "seed": SCENARIO_SEED, "lanes": L, "seconds": wall, "lanes_per_s": L / wall,
            "outer_iters": meta["outer_iters"], "host_syncs": meta["host_syncs"],
            "launches": {k: v for k, v in launches.items() if v}, **per_iter,
            "families": fams, "holm_rejects_info": len(fails),
            "z_max_info": max(r.z for r in rows)}

    # the gate: the validation grid at 200 runs, the card against the CPU
    t1 = time.monotonic()
    val = scenario_grid("validation", VALIDATION_RUNS, VALIDATION_SEED)
    vres = run_grid(val, device="cuda")
    worst = card_vs_cpu_modes(vres, run_grid(val, device="cpu"))
    rows, fails = validate_sweep(vres, alpha=VALIDATION_ALPHA)
    check(len(rows) == 24 and not fails, f"scenario gate: {len(fails)} Holm rejects of "
          f"{len(rows)}: " + "; ".join(f"{r.label} z={r.z:.2f}" for r in fails))
    check(all(r.se_sim > 0 for r in rows), "scenario gate: a cell has se_sim <= 0")
    check(all(c.mean_detections > 0 for c in vres.cells if c.cell.label.startswith("sil/")),
          "scenario gate: a silent cell detected nothing")
    gate = {"grid": "validation", "cells": len(rows), "runs_per_cell": VALIDATION_RUNS,
            "seed": VALIDATION_SEED, "rejects": 0, "z_max": max(r.z for r in rows),
            "card_vs_cpu_max_rel_float": worst, "families": family_counts(vres),
            "seconds": time.monotonic() - t1}

    # two laws in one fused dispatch (the law-indexed silent walk) against
    # one dispatch per law, lane for lane
    t1 = time.monotonic()
    from dataclasses import replace

    from repro_torch.core.events import weibull
    from repro_torch.experiments import GridSpec

    two = GridSpec(tuple(replace(c, label=f"{tag}/{c.label}")
                         for tag, law in (("exp", None), ("weibull", weibull(0.7)))
                         for c in scenario_grid("validation", 1, 0, law).cells),
                   n_runs=SCENARIO_MIXED_RUNS, seed=VALIDATION_SEED)
    reset_counts(K)
    fused = run_grid(two, device="cuda", collect="lanes")
    mixed_launches = counts(K)
    fam = run_grid(two, device="cuda", collect="lanes", dispatch="perfamily")
    check((fused.meta["dispatches"], fam.meta["dispatches"]) == (1, 2)
          and mixed_launches[SILENT + "[indexed]"] > 0, "scenario two-law dispatches")
    for a, b in zip(fused.cells, fam.cells):
        for f in ("makespan", "n_faults", "n_regular_ckpts", "n_proactive_ckpts",
                  "n_disk_recoveries", "n_detections"):
            check(np.array_equal(getattr(a, f), getattr(b, f)),
                  f"{a.cell.label}: {f} differs fused vs perfamily")
    two_law = {"cells": len(two.cells), "runs_per_cell": SCENARIO_MIXED_RUNS,
               "silent_walk_indexed_launches": mixed_launches[SILENT + "[indexed]"],
               "seconds": time.monotonic() - t1}

    # the paper grid at fractional trust: the card's path, then the card
    # against the CPU on the validation preset
    t1 = time.monotonic()
    tgrid = trust_grid("full", RUNS_PER_CELL)
    tcap = capture_walks(tgrid, dev, CAPTURE_ITER)
    check(all("q_eff" in tcap[n].flat for n in ("skip", "pop")),
          "the fractional grid's prediction walks carry no trust coins")
    reset_counts(K)
    torch.cuda.synchronize()
    t2 = time.monotonic()
    tres = run_grid(tgrid, device="cuda")
    torch.cuda.synchronize()
    trust_wall = time.monotonic() - t2
    trust_launches = counts(K)
    tper_iter = path_launches(trust_launches, tres.meta, "")
    small = trust_grid("validation", 8)
    tworst = card_vs_cpu(run_grid(small, device="cuda"), run_grid(small, device="cpu"))
    trust = {"grid": "full", "cells": len(tgrid.cells), "runs_per_cell": RUNS_PER_CELL,
             "qs": list(TRUST_QS), "seconds": trust_wall, "outer_iters": tres.meta["outer_iters"],
             "host_syncs": tres.meta["host_syncs"],
             "launches": {k: v for k, v in trust_launches.items() if v}, **tper_iter,
             "card_vs_cpu_validation_max_rel_float": tworst,
             "phase_seconds": time.monotonic() - t1}
    emit("scenario_path", scenario=scen, gate=gate, two_law=two_law, trust=trust,
         note="holm_rejects_info / z_max_info: the full grid's validation, as "
              "information; the gate is the validation grid's")

    # ---- times of the new walks --------------------------------------- #
    t0 = time.monotonic()
    sil_times = {SILENT: time_walks(K, {"silent": sc}, None, False, "scenario")["silent"],
                 SILENT + "[indexed]": time_walks(K, {"silent": sc}, ("indexed", lane_laws),
                                                  True, "scenario")["silent"]}
    trust_times = time_walks(K, {n: tcap[n] for n in ("skip", "pop")}, None, False,
                             "trust path")
    emit("scenario_walk_timing", seconds=time.monotonic() - t0, iteration=CAPTURE_ITER,
         silent=sil_times, trust=trust_times,
         registers={n: regs.get(n) for n in (SILENT, SILENT + "[indexed]")},
         note="silent: the scenario grid's captured iteration (the indexed variant under "
              "per-lane laws in runs of 1000 lanes); trust: the fractional paper grid's "
              "captured skip walk and pop; device_ms over restored copies")
    trust_mean = {k: (trust_times["skip"][k] + trust_times["pop"][k]) / 2
                  for k in ("ms", "plain_ms", "host_call_ms", "launch_floor_ms", "bytes", "ops")}
    out = [sim_step_entry(name, REPLACES_ADV, tm,
                          launches[SILENT] if name == SILENT else two_law[
                              "silent_walk_indexed_launches"],
                          err[name], lanes=L, iteration=CAPTURE_ITER,
                          path="scenario grid" if name == SILENT else "scenario, two laws",
                          registers=regs.get(name))
           for name, tm in sil_times.items()]
    out.append(sim_step_entry(
        "masked_prediction_walk[trust]", REPLACES_ADV, trust_mean,
        trust_launches["masked_prediction_walk"], err["masked_prediction_walk[trust]"],
        calls=trust_times, lanes=tgrid.n_lanes, iteration=CAPTURE_ITER,
        path="paper grid at q 0.3 / 0.5", registers=regs.get("masked_prediction_walk")))
    return out


# --------------------------------------------------------------------------- #
# The host trace mode: host-drawn slabs, the trace-fed primitive, slab walks
# --------------------------------------------------------------------------- #
def f64_bits(t):
    """The bit pattern of an f64 tensor (other tensors as they are)."""
    import torch

    return t.view(torch.int64) if t.dtype == torch.float64 else t


#: the TPU kernel body and the reference loops the host mode's kernels replace
HOST_REPLACES = {
    "masked_primitive_update[host]": "src/repro/kernels/sim_step.py:465",
    "masked_slab_prediction_skip": "src/repro/core/jax_sim.py:460",
    "masked_slab_strike_walk": "src/repro/core/jax_sim.py:689",
    "masked_slab_silent_walk": "src/repro/core/jax_sim.py:812",
}
SLAB_WALKS = ("masked_slab_prediction_skip", "masked_slab_strike_walk",
              "masked_slab_silent_walk")
#: phase 28's sub-grid: cells at this platform size, runs a cell
HOST_SUB_N, HOST_SUB_RUNS = 2**14, 200
#: phase 29: the runs and seed of the reference's Tables 1-2 benchmark
TABLES_RUNS, TABLES_SEED = 30, 100


class SlabCall:
    """One captured slab-walk call: the per-lane arguments and the cancel
    marks cloned before the call, the read-only event slabs held as they
    are.  ``mutable`` names what the call updates in place (keys ``a<i>``
    for positional arguments); :meth:`call` runs it on copies of those."""

    OUT = {"skip": ("a4",), "strike": ("a1", "a2", "a3"), "silent": ("a2", "a3")}
    FN = {"skip": "slab_prediction_skip", "strike": "slab_strike_walk",
          "silent": "slab_silent_walk"}

    def __init__(self, name: str, args, kw):
        import torch

        def keep(v):
            if not isinstance(v, torch.Tensor):
                return v
            slab = v.dim() == 2 and v.dtype == torch.float64
            return v if slab else v.clone()

        self.name = name
        self.args = [keep(a) for a in args]
        self.kw = {k: keep(v) for k, v in kw.items() if k != "tally"}
        self.mutable = self.OUT[name] + (("Fcancel",) if "Fcancel" in self.kw else ())

    def src(self) -> dict:
        return {k: self.args[int(k[1:])] if k[0] == "a" else self.kw[k] for k in self.mutable}

    def copy(self) -> dict:
        return {k: v.clone() for k, v in self.src().items()}

    def head(self, n: int) -> "SlabCall":
        """The same call on the first ``n`` lanes."""
        import torch

        def cut(v):
            if not isinstance(v, torch.Tensor):
                return v
            return (v[:, :n] if v.dim() == 2 else v[:n]).contiguous()

        out = SlabCall.__new__(SlabCall)
        out.name, out.mutable = self.name, self.mutable
        out.args = [cut(a) for a in self.args]
        out.kw = {k: cut(v) for k, v in self.kw.items()}
        return out

    def call(self, K, d: dict, *, plain: bool = False):
        args = [d.get(f"a{i}", a) for i, a in enumerate(self.args)]
        kw = {k: d.get(k, v) for k, v in self.kw.items()}
        fn = getattr(K, ("" if plain else "masked_") + self.FN[self.name])
        outs = self.OUT[self.name]

        def go():
            r = fn(*args, **kw)
            r = r if isinstance(r, tuple) else (r,)
            if plain:  # the plain versions return new tensors
                for k, v in zip(outs, r):
                    args[int(k[1:])].copy_(v)
            return r

        return go

    def run(self, K, *, plain: bool = False) -> dict:
        import torch

        d = self.copy()
        self.call(K, d, plain=plain)()
        torch.cuda.synchronize()
        return d

    def work(self, out: dict) -> dict:
        """What the call must do on its inputs: the rows its lanes step
        (``steps``), the lanes that walk, the bytes (every lane's masks;
        the masked lanes' record and the slab row at their cursor; one
        slab row (and cancel mark) a step; the walking lanes' writes;
        a cancel's search rows and its mark), and 2 f64 operations (a
        compare and an add) a step."""
        import torch

        a, kw = self.args, self.kw
        L = a[0].numel()
        cur = {"skip": "a4", "strike": "a2", "silent": "a2"}[self.name]
        before = a[int(cur[1:])]
        moved = out[cur] - before
        steps, walking = int(moved.sum()), int((moved != 0).sum())
        masked = int(a[0].sum())
        mig = "Fcancel" in kw
        if self.name == "skip":  # mask; t, lead_act, pi, P0[pi]; write pi
            nbytes = L + 32 * masked + 8 * steps + 8 * walking
        elif self.name == "silent":  # silr; t, fi, F[fi]; corrupt; writes
            nbytes = L + 24 * masked + 8 * steps + 8 * walking + 16 * walking
        else:  # res (can); t, fi, F[fi] (mark); rc, n_faults; writes
            F = a[5]
            nbytes = (L * (1 + mig) + masked * (24 + mig) + steps * (8 + mig)
                      + walking * (16 + 24))
            if mig:
                can, ep_ft, marks = kw["can"], kw["ep_ft"], kw["Fcancel"]
                rows = torch.arange(F.shape[0], device=F.device)[:, None]
                stop = (rows >= a[2][None, :]) & (
                    (F > ep_ft[None, :]) | ((F == ep_ft[None, :]) & ~marks)
                    | (rows == F.shape[0] - 1))
                first = torch.where(stop, rows, F.shape[0]).min(dim=0).values
                searched = int(((first - a[2] + 1) * can).sum())
                nbytes += 16 * int(can.sum()) + 9 * searched + int(
                    (out["Fcancel"] & ~marks).sum())
        return {"bytes": nbytes, "ops": 2 * steps, "steps": steps,
                "walking_lanes": walking, "masked_lanes": masked}


def capture_slab_walks(layout, dev, at: int, names) -> dict:
    """Run ``layout``'s host traces on the card for ``at + 1`` outer
    iterations and keep the arguments of iteration ``at``'s slab walks
    (``names`` of "skip", "strike", "silent") as they were before each
    call: {name: :class:`SlabCall`}.  torch_sim's wrappers are wrapped
    for the run and restored after it."""
    from repro_torch.core import torch_sim as PT

    real = {n: getattr(PT, n) for n in SLAB_WALKS}
    seen = dict.fromkeys(("skip", "strike", "silent"), 0)
    cap = {}

    def spy(name, fn):
        def wrapped(*args, **kw):
            if name in names and seen[name] == at:
                cap[name] = SlabCall(name, args, kw)
            seen[name] += 1
            return fn(*args, **kw)

        return wrapped

    for short, n in zip(("skip", "strike", "silent"), SLAB_WALKS):
        setattr(PT, n, spy(short, real[n]))
    try:
        PT.simulate_batch_torch(layout.work_c, layout.plats_c, layout.strats_c,
                                layout.traces, cell_index=layout.cidx, device=dev,
                                max_iters=at + 1)
        raise SmokeFailure(f"the grid finished within {at + 1} iterations")
    except RuntimeError as e:
        if "did not converge" not in str(e):
            raise
    finally:
        for n, fn in real.items():
            setattr(PT, n, fn)
    check(sorted(cap) == sorted(names), f"captured slab walks {sorted(cap)}")
    return cap


def prim_host_call(K, s, plain: bool = False):
    """One trace-fed primitive update (no stream) on lanes ``s``."""
    fn = K.primitive_update if plain else K.masked_primitive_update
    return lambda: fn(*(s[k] for k in PRIM_ARGS), eps=1e-6, reg_cont=1)


def slab_times(K, c: SlabCall, want: dict, what: str) -> dict:
    """Times of one captured slab walk: the kernel on copies restored
    before every replay (``device_ms``), its outputs held to the plain
    version's, the plain version eagerly, the wrapper's host cost and the
    launch floor (128 lanes)."""
    import torch

    copy_bytes = sum(v.numel() * v.element_size() for v in c.src().values())
    n_copies = max(2, math.ceil(3 * L2_BYTES / copy_bytes))
    cs = [c.copy() for _ in range(n_copies)]
    ms, _ = device_ms([c.call(K, d) for d in cs], cs, c.src())
    for k, w in want.items():
        check(torch.equal(f64_bits(cs[0][k]), f64_bits(w)),
              f"{what}: a timed call's {k} is not the plain version's")
    small = c.head(128)
    floor_copies = [small.copy() for _ in range(64)]
    return {
        "ms": ms,
        "plain_ms": restored_eager_ms(lambda d: c.call(K, d, plain=True), c.src()),
        "host_call_ms": eager_ms(c.call(K, c.copy()), 200),
        "launch_floor_ms": device_ms([small.call(K, d) for d in floor_copies],
                                     floor_copies, small.src())[0],
        "copies": n_copies, **c.work(want),
    }


def host_sub_grid():
    """Phase 28's sub-grid: 12 cells at N = ``HOST_SUB_N`` covering
    fail-stop (Young, exact dates, two windows), migration, two-level,
    silent errors and trust q of 0, 0.5 and 1."""
    from dataclasses import replace

    from repro_torch.experiments import (GridSpec, paper_grid_cells, silent_grid_cells,
                                         two_level_grid_cells)

    paper = {c.label.split("/", 2)[0] + "/" + c.label.split("/", 2)[2]: c
             for c in paper_grid_cells("validation", n_list=[HOST_SUB_N])}
    cells = [paper[k] for k in ("p82r85/Young", "p82r85/Exact", "p82r85/Migration",
                                "p82r85/I1200/Instant", "p82r85/I6000/WithCkptI")]
    cells += [replace(paper[k], strategy=replace(paper[k].strategy, q=0.5))
              for k in ("p40r70/Exact", "p40r70/Migration")]
    cells += two_level_grid_cells("validation", n_list=[HOST_SUB_N])[:3]
    cells += silent_grid_cells("validation", n_list=[HOST_SUB_N])
    return GridSpec(tuple(cells), n_runs=HOST_SUB_RUNS, seed=VALIDATION_SEED)


def tables_cells():
    """The paper's Tables 1-2 grid as the port's driver builds it
    (``repro_torch.paper.sim_tables.build_cells(quick=False)``, the
    reference benchmark's 120 cells), plus its Weibull 0.5 family again
    with stationary components: 40 more."""
    from dataclasses import replace

    from repro_torch.paper.sim_tables import build_cells

    cells = build_cells(quick=False)
    stationary = [replace(c, stationary=True, label=c.label.replace("-fresh", "-stationary"))
                  for c in cells if c.n_components]
    return cells + stationary


def cpu_cell_z(layout, positions) -> dict:
    """The z of the cells at ``positions`` (of ``layout.cell_order``) as
    the port computes them on the CPU from the same host traces: one
    engine call a cell (the paper grid's trust levels are 0 and 1, so its
    lanes are the fused run's)."""
    import numpy as np
    from repro_torch.core.torch_sim import simulate_batch_torch
    from repro_torch.experiments import CellResult, SweepResult
    from repro_torch.experiments.validation import cell_z_rows

    cells = []
    for k in positions:
        lo, hi = int(layout.offs[k]), int(layout.offs[k + 1])
        n = hi - lo
        res = simulate_batch_torch(np.full(n, layout.work_c[k]), [layout.plats_c[k]] * n,
                                   [layout.strats_c[k]] * n,
                                   layout.traces.take(np.arange(lo, hi)), device="cpu",
                                   collect="lanes")
        cells.append(CellResult(cell=layout.grid.cells[layout.cell_order[k]],
                                waste=res.waste, makespan=res.makespan, n_faults=res.n_faults))
    rows = cell_z_rows(SweepResult(grid=layout.grid, cells=cells, engine="torch",
                                   wall_time_s=0.0, collect="lanes"))
    return {r.label: r.z for r in rows}


def host_phases(dev, regs: dict) -> list:
    """Phases 26-29: the host trace mode.  The trace-fed primitive update
    and the three slab walks against their plain versions (the walks on
    iteration 40 of the host-mode full grid and scenario grid); the full
    grid in host mode (the main host path: wall split, slabs, launches,
    the validation gate) and the scenario grid in host mode; card against
    CPU and fused against per-cell on a 12-cell sub-grid; the Tables 1-2
    grid through ``run_cells``.  Returns the four new entries of the
    ``kernels`` line."""
    import numpy as np
    import torch
    from repro_torch.experiments import (GridSpec, build_fused_layout, paper_grid_cells,
                                         run_cells, run_grid, validate_sweep)
    from repro_torch.kernels import sim_step as K

    full = GridSpec(tuple(paper_grid_cells("full")), n_runs=RUNS_PER_CELL, seed=0)
    scen = scenario_grid("full", RUNS_PER_CELL, SCENARIO_SEED)
    L = full.n_lanes

    # ---- 26. the host-mode kernels against their plain versions -------- #
    t0 = time.monotonic()
    err, work = {}, {}
    x = make_inputs(K, L, 300, dev)
    s_got, s_want = {k: v.clone() for k, v in x.items()}, {k: v.clone() for k, v in x.items()}
    got = prim_host_call(K, s_got)()
    want = prim_host_call(K, s_want, plain=True)()
    torch.cuda.synchronize()
    for k, g, w in zip(("t", "saved", "unsaved", "pw", "flags"), got, want):
        check(torch.equal(f64_bits(g), f64_bits(w)),
              f"masked_primitive_update[host]: {k} differs from the plain version")
    n_fault = int(want[4].bitwise_and(1).ne(0).sum())
    check(n_fault > 0, "the trace-fed primitive's inputs exercised no fault")
    err["masked_primitive_update[host]"] = max_abs_err(zip(got[:4], want[:4]))
    t1 = time.monotonic()
    layout = build_fused_layout(full, "host")
    scen_layout = build_fused_layout(scen, "host")
    gen_s = time.monotonic() - t1
    cap = capture_slab_walks(layout, dev, CAPTURE_ITER, ("skip", "strike"))
    cap.update(capture_slab_walks(scen_layout, dev, CAPTURE_ITER, ("silent",)))
    check("Fcancel" in cap["strike"].kw, "the full grid's strike walk carries no cancel marks")
    for name, c in cap.items():
        wrapper = SLAB_WALKS[("skip", "strike", "silent").index(name)]
        g, w = c.run(K), c.run(K, plain=True)
        for k in w:
            check(torch.equal(f64_bits(g[k]), f64_bits(w[k])),
                  f"{wrapper}: {k} differs from the plain version")
        err[wrapper] = max_abs_err((g[k], w[k]) for k in w if w[k].dtype == torch.float64)
        work[wrapper] = c.work(w)
        check(work[wrapper]["steps"] > 0, f"{wrapper}: the captured call walks no lane")
    emit("host_check", seconds=time.monotonic() - t0, lanes=L, faulted_lanes=n_fault,
         iteration=CAPTURE_ITER, host_gen_s_capture_layouts=gen_s,
         slab_shapes={n: list(c.args[3 if n == "skip" else -1].shape) for n, c in cap.items()},
         cancel_lanes=int(cap["strike"].kw["can"].sum()), work=work,
         compared="trace-fed primitive update (no stream) on 108,000 sampled lanes and the "
                  "slab walks on iteration 40 of the host-mode full grid (skip, strike with "
                  "cancel marks) and scenario grid (silent): every output bit-equal to the "
                  "plain version")

    # ---- 27. the main host path: the full grid, host-drawn traces ------ #
    reset_counts(K)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    res = run_grid(full, device="cuda", trace_mode="host")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = counts(K)
    meta = res.meta
    iters = max(meta["outer_iters"], 1)
    check(meta["device"].startswith("cuda") and meta["trace_mode"] == "host"
          and meta["dispatches"] == 1, f"host path: {meta['device']} {meta['trace_mode']}")
    for name in ("masked_primitive_update[host]", "masked_slab_prediction_skip",
                 "masked_slab_strike_walk"):
        check(launches[name] == iters, f"{name}: {launches[name]} launches in {iters} "
              "outer iterations (one an iteration)")
    for name, n in launches.items():
        if name not in ("masked_primitive_update[host]", "masked_slab_prediction_skip",
                        "masked_slab_strike_walk"):
            check(n == 0, f"{name}: {n} launches on the host-mode fail-stop path")
    check(meta["host_syncs"] / iters <= 1.0, f"{meta['host_syncs'] / iters} syncs an iteration")
    for c in res.cells:
        check(c.n_runs == RUNS_PER_CELL and 0.0 < c.mean_waste < 1.0
              and np.isfinite(c.ci95_waste), f"{c.cell.label}: waste {c.mean_waste}")
    anchors = {}
    for pk in ("p82r85", "p40r70"):
        y, e = res[f"{pk}/N65536/Young"].mean_waste, res[f"{pk}/N65536/Exact"].mean_waste
        check(e < y, f"host path {pk}: ExactPrediction does not beat Young ({e} >= {y})")
        anchors[pk] = {"Young": y, "Exact": e}
    t1 = time.monotonic()
    rows, fails = validate_sweep(res, alpha=VALIDATION_ALPHA)
    check(len(rows) == 108 and all(math.isfinite(r.z) for r in rows), "host path z rows")
    near = sorted(rows, key=lambda r: r.z, reverse=True)[:3]
    pos = {layout.grid.cells[ci].label: k for k, ci in enumerate(layout.cell_order)}
    cpu_z = cpu_cell_z(layout, [pos[r.label] for r in ([near[0]] + fails)[:3]])
    gate = {"alpha": VALIDATION_ALPHA, "cells": len(rows), "rejects": len(fails),
            "rejected": [{"label": r.label, "z": r.z, "cpu_z": cpu_z.get(r.label),
                          "share_of_margin": abs(r.delta) / r.margin} for r in fails],
            "z_max": near[0].z, "cpu_z_of_z_max_cell": cpu_z[near[0].label],
            "abs_z_max": max(abs(r.z) for r in rows),
            "nearest": [{"label": r.label, "z": r.z, "mean_sim": r.mean_sim,
                         "analytic": r.analytic, "share_of_margin": abs(r.delta) / r.margin}
                        for r in near],
            "seconds": time.monotonic() - t1}
    emit("host_path", grid="full", cells=len(res.cells), runs_per_cell=RUNS_PER_CELL,
         lanes=L, seed=0, seconds=wall, lanes_per_s=L / wall,
         split={k: meta[k] for k in ("host_gen_s", "pack_s", "copy_s", "loop_s")},
         slab_bytes=meta["slab_bytes"], slabs=meta["slabs"], n_chunks=meta["n_chunks"],
         outer_iters=meta["outer_iters"], host_syncs=meta["host_syncs"],
         syncs_per_iter=meta["host_syncs"] / iters,
         launches={k: v for k, v in launches.items() if v},
         launches_per_iter={k: v / iters for k, v in launches.items() if v},
         waste_N65536=anchors, validation=gate,
         note="split: host generation of the traces (make_event_traces_batch), packing "
              "(trust filter, slabs into pinned memory), host-to-device copy (CUDA "
              "events) and the lane loop (wall); a Holm reject is reported beside the "
              "CPU port's z for the cell, from the same traces")
    main_launches = launches

    # the scenario grid in host mode: the silent slab walk's path
    reset_counts(K)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    sres = run_grid(scen, device="cuda", trace_mode="host")
    torch.cuda.synchronize()
    swall = time.monotonic() - t0
    slaunches = counts(K)
    smeta = sres.meta
    check(slaunches["masked_slab_silent_walk"] > 0,
          "the silent slab walk was not launched on the host-mode scenario path")
    fams = family_counts(sres)
    check(fams["tl"]["disk_recoveries"] > 0 and fams["sil"]["detections"] > 0,
          f"host scenario path: {fams}")
    emit("host_scenario_path", cells=len(sres.cells), runs_per_cell=RUNS_PER_CELL,
         seed=SCENARIO_SEED, seconds=swall,
         split={k: smeta[k] for k in ("host_gen_s", "pack_s", "copy_s", "loop_s")},
         slab_bytes=smeta["slab_bytes"], outer_iters=smeta["outer_iters"],
         host_syncs=smeta["host_syncs"],
         launches={k: v for k, v in slaunches.items() if v}, families=fams)

    # ---- 28. card against CPU, fused against per-cell ----------------- #
    t0 = time.monotonic()
    sub = host_sub_grid()
    worst = card_vs_cpu_modes(run_grid(sub, device="cuda", trace_mode="host"),
                              run_grid(sub, device="cpu", trace_mode="host"))
    det = GridSpec(tuple(c for c in sub.cells if c.strategy.q in (0.0, 1.0)),
                   n_runs=sub.n_runs, seed=sub.seed)
    percell = {}
    for mode, grid in (("host", det), ("device", sub)):
        fused = run_grid(grid, device="cuda", collect="lanes", trace_mode=mode)
        each = run_grid(grid, device="cuda", collect="lanes", trace_mode=mode,
                        dispatch="percell")
        check(each.meta["dispatches"] == len(grid.cells), f"{mode} percell dispatches")
        for a, b in zip(fused.cells, each.cells):
            for f in ("makespan", "n_faults", "n_proactive_ckpts", "n_regular_ckpts",
                      "n_migrations", "n_disk_recoveries", "n_detections"):
                check(np.array_equal(getattr(a, f), getattr(b, f)),
                      f"{mode} {a.cell.label}: {f} differs fused vs percell")
        percell[mode] = {"cells": len(grid.cells), "dispatches": each.meta["dispatches"]}
    emit("host_card_vs_cpu", seconds=time.monotonic() - t0, cells=len(sub.cells),
         runs_per_cell=sub.n_runs, N=HOST_SUB_N, max_rel_float=worst, rtol=1e-9,
         fused_vs_percell=percell,
         note="card vs CPU in host mode: integer columns (disk recoveries and detections "
              "too) exact, moments rtol 1e-9; fused vs percell lane for lane, host mode on "
              "the cells of trust 0 and 1 (a fractional q's host coins are drawn per "
              "engine call), device mode on every cell")

    # ---- 29. the paper's Tables 1-2, superposed and stationary --------- #
    cells = tables_cells()
    reset_counts(K)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    tres = run_cells(cells, n_runs=TABLES_RUNS, seed=TABLES_SEED, device="cuda",
                     trace_mode="host")
    torch.cuda.synchronize()
    twall = time.monotonic() - t0
    tlaunches = counts(K)
    tmeta = tres.meta
    check(len(tres.cells) == 160 and all(np.isfinite(c.mean_waste) and 0.0 < c.mean_waste < 1.0
                                         for c in tres.cells), "tables: a cell's waste")
    families = {}
    for c in tres.cells:
        fam = c.cell.label.split("/")[1]
        f = families.setdefault(fam, {"cells": 0, "exhausted": 0, "gain_vs_young": []})
        f["cells"] += 1
        f["exhausted"] += c.n_exhausted
        if c.cell.strategy.name != "Young":
            base = tres[c.cell.label.rsplit("/", 1)[0] + "/Young"].mean_makespan
            f["gain_vs_young"].append(1.0 - c.mean_makespan / base)
    for f in families.values():
        g = f.pop("gain_vs_young")
        f.update(gain_vs_young_min=min(g), gain_vs_young_max=max(g))
    emit("tables", cells=len(tres.cells), runs_per_cell=TABLES_RUNS, seed=TABLES_SEED,
         seconds=twall, host_gen_s=tmeta["host_gen_s"], pack_s=tmeta["pack_s"],
         copy_s=tmeta["copy_s"], loop_s=tmeta["loop_s"], slab_bytes=tmeta["slab_bytes"],
         slabs=tmeta["slabs"], outer_iters=tmeta["outer_iters"],
         host_syncs=tmeta["host_syncs"], launches={k: v for k, v in tlaunches.items() if v},
         families=families,
         note="repro_torch.paper.sim_tables.build_cells(quick=False) (the reference "
              "benchmark's grid) plus the Weibull 0.5 "
              "family with stationary components, one run_cells call in host trace mode; "
              "host_gen_s: the NumPy trace generation, loop_s: the lane loop on the card")

    # ---- times of the host-mode kernels -------------------------------- #
    t0 = time.monotonic()
    xs = make_inputs(K, 128, 301, dev)
    want_h = dict(zip(("t", "saved", "unsaved", "pw", "flags"), want))
    n_copies = math.ceil(3 * L2_BYTES / (BYTES_PRIM * L))
    prim_t = {
        "ms": timed(lambda c: prim_host_call(K, c), x, n_copies, want_h,
                    "masked_primitive_update[host]"),
        "plain_ms": timed(lambda c: prim_host_call(K, c, plain=True), x, n_copies, want_h,
                          "masked_primitive_update[host] (plain)"),
        "launch_floor_ms": timed(lambda c: prim_host_call(K, c), xs, 64),
        "host_call_ms": eager_ms(prim_host_call(K, {k: v.clone() for k, v in x.items()}),
                                 200),
        "bytes": BYTES_PRIM * L, "ops": OPS_PRIM * L, "copies": n_copies,
    }
    times = {"masked_primitive_update[host]": prim_t}
    for name, c in cap.items():
        wrapper = SLAB_WALKS[("skip", "strike", "silent").index(name)]
        times[wrapper] = slab_times(K, c, c.run(K, plain=True), wrapper)
    emit("host_timing", seconds=time.monotonic() - t0, lanes=L, iteration=CAPTURE_ITER,
         times=times, registers={n: regs.get(n) for n in SLAB_WALKS + (
             "masked_primitive_update",)},
         note="primitive: device_ms over copies of 108,000 sampled lanes; walks: the "
              "captured iteration's calls, device_ms over copies of what they update "
              "(the slabs are read-only and shared); plain_ms: the plain version")
    path_of = {"masked_slab_silent_walk": ("host-mode scenario grid", slaunches)}
    out = []
    for name, tm in times.items():
        path, lc = path_of.get(name, ("host-mode full grid", main_launches))
        out.append(sim_step_entry(
            name, HOST_REPLACES[name], tm, lc[name], err[name], path=path,
            registers=regs.get("masked_primitive_update" if name.endswith("[host]")
                               else name),
            **({"lanes": L, "faulted_lanes": n_fault} if name.endswith("[host]")
               else {"iteration": CAPTURE_ITER})))
    return out


# --------------------------------------------------------------------------- #
# The engine API: EngineConfig, devices=, BestPeriod, the paper's drivers
# --------------------------------------------------------------------------- #
#: phase 32: BestPeriod's families, platform size, runs and seed (the
#: paper's 100 runs, the default period grid: 1,000 lanes a call)
SEARCH_FAMILIES = ("young", "daly", "exact", "instant", "nockpt", "withckpt", "migration")
SEARCH_N, SEARCH_RUNS, SEARCH_SEED = 2**19, 100, 0
#: phase 30: the scalar engine checks the first lanes of every cell
SCALAR_LANES = 8
#: the host-trace kernels (one launch of each an iteration of a
#: fail-stop host-mode call)
HOST_KERNELS = ("masked_primitive_update[host]", "masked_slab_prediction_skip",
                "masked_slab_strike_walk")
LANE_INTS = ("n_faults", "n_proactive_ckpts", "n_regular_ckpts", "n_migrations",
             "n_disk_recoveries", "n_detections")


def lanes_agree(got, want, what: str, cells=None, rtol: float = 0.0) -> float:
    """Hold two per-run sweeps' cells to each other: integer columns and
    exhaustion exact, makespans within ``rtol`` (0: bit for bit).  Only
    the cells labelled in ``cells`` when given.  Returns the largest
    relative makespan gap."""
    import numpy as np

    worst = 0.0
    for a, b in zip(got.cells, want.cells):
        if cells is not None and a.cell.label not in cells:
            continue
        check(a.cell.label == b.cell.label, f"{what}: cell order")
        for k in LANE_INTS:
            check(np.array_equal(getattr(a, k), getattr(b, k)),
                  f"{what} {a.cell.label}: {k} differs")
        check(a.n_exhausted == b.n_exhausted, f"{what} {a.cell.label}: exhaustion differs")
        rel = float(np.max(np.abs(a.makespan - b.makespan) / np.abs(b.makespan)))
        worst = max(worst, rel)
        check(rel <= rtol, f"{what} {a.cell.label}: makespan rel {rel} > {rtol}")
    return worst


def stats_agree(got, want, what: str, rtol: float) -> float:
    """Per-cell stats: integer columns exact, moments within ``rtol``."""
    worst = 0.0
    for a, b in zip(got.cells, want.cells):
        for k in ("n", "mean_faults", "mean_proactive_ckpts", "mean_regular_ckpts",
                  "mean_migrations", "mean_disk_recoveries", "mean_detections"):
            check(a.stats[k] == b.stats[k], f"{what} {a.cell.label}: {k} differs")
        check(a.n_exhausted == b.n_exhausted, f"{what} {a.cell.label}: exhaustion")
        for k in ("mean_waste", "ci95_waste", "mean_makespan", "ci95_makespan"):
            rel = abs(a.stats[k] - b.stats[k]) / abs(b.stats[k])
            worst = max(worst, rel)
            check(rel <= rtol, f"{what} {a.cell.label}: {k} rel {rel} > {rtol}")
    return worst


def driver_records(run) -> list:
    """The (name, derived) records a paper driver emits, its stdout kept
    out of this script's."""
    import contextlib
    import io

    from repro_torch.paper import common as PC

    PC.reset_records()
    with contextlib.redirect_stdout(io.StringIO()):
        run()
    return [(r["name"], r["derived"]) for r in PC.RECORDS]


def engine_phases(dev) -> None:
    """Phases 30-33: the engine API.  ``run_grid`` through an
    ``EngineConfig`` against the keyword call, and the torch engine's
    lanes against the NumPy and scalar engines on the same traces;
    ``devices=`` in its four spellings; BestPeriod
    (``optimize(method="search")``) on the card against the NumPy engine,
    with each call's iterations and launches; the paper's drivers on the
    card against the NumPy engine."""
    import numpy as np
    import torch
    from repro_torch.configs.paper import platform
    from repro_torch.core import EngineConfig, optimize, simulate
    from repro_torch.core.waste import PredictorModel
    from repro_torch.experiments import build_fused_layout, run_grid
    from repro_torch.kernels import sim_step as K
    from repro_torch.paper import recall_precision, simulate_cluster, waste_curves

    sub = host_sub_grid()
    det = {c.label for c in sub.cells if c.strategy.q in (0.0, 1.0)}

    # ---- 30. EngineConfig, and the host engines on the same traces ----- #
    t0 = time.monotonic()
    api = {}
    for mode in ("host", "device"):
        # the EngineConfig call is the keyword call, bit for bit: per-run
        # lanes and per-cell stats (their sums in a fixed order)
        lanes = run_grid(sub, EngineConfig(trace_mode=mode), device=dev)
        lanes_agree(lanes, run_grid(sub, device=dev, trace_mode=mode, collect="lanes"),
                    f"engine_api {mode} lanes")
        keyword = run_grid(sub, device=dev, trace_mode=mode)
        configured = run_grid(sub, EngineConfig(trace_mode=mode, collect="stats"),
                              device=dev)
        check(keyword.collect == configured.collect == "stats", "engine_api collect")
        stats_agree(configured, keyword, f"engine_api {mode} config", 0.0)
        # and the per-cell sums reduced on the card are the mean of its lanes
        lane_rel = max(abs(a.mean_waste - b.stats["mean_waste"]) / b.stats["mean_waste"]
                       for a, b in zip(lanes.cells, keyword.cells))
        check(lane_rel <= 1e-12, f"engine_api {mode}: stats vs lanes mean waste {lane_rel}")
        # the NumPy engine on the same traces (device mode: the streams
        # replayed on the host; a fractional q's coins differ there)
        cells = None if mode == "host" else det
        tb = time.monotonic()
        batch = run_grid(sub, EngineConfig(engine="batch", trace_mode=mode))
        batch_s = time.monotonic() - tb
        rel_b = lanes_agree(lanes, batch, f"engine_api {mode} torch vs batch", cells, 1e-9)
        # the scalar engine on the first lanes of each cell of trust 0 or 1
        # (its fractional-q coins are its own)
        layout = build_fused_layout(sub, mode)
        traces = layout.host_traces()
        rel_s, n_scalar = 0.0, 0
        for k, ci in enumerate(layout.cell_order):
            got = lanes.cells[ci]
            if got.cell.label not in det:
                continue
            lo = int(layout.offs[k])
            for j in range(SCALAR_LANES):
                r = simulate(float(layout.work_c[k]), layout.plats_c[k], layout.strats_c[k],
                             traces.lane(lo + j),
                             np.random.default_rng([sub.seed, layout.n_groups, lo + j]))
                for f in LANE_INTS:
                    check(getattr(r, f) == getattr(got, f)[j],
                          f"engine_api {mode} {got.cell.label} lane {j}: {f} torch vs scalar")
                rel = abs(r.makespan - got.makespan[j]) / r.makespan
                check(rel <= 1e-9, f"engine_api {mode} {got.cell.label} lane {j}: makespan "
                      f"rel {rel}")
                rel_s, n_scalar = max(rel_s, rel), n_scalar + 1
        api[mode] = {"stats_vs_lanes_mean_waste_rel": lane_rel,
                     "cells_vs_batch": len(cells or sub.cells), "max_rel_vs_batch": rel_b,
                     "batch_s": batch_s, "scalar_lanes": n_scalar,
                     "max_rel_vs_scalar": rel_s}
    emit("engine_api", seconds=time.monotonic() - t0, cells=len(sub.cells),
         runs_per_cell=sub.n_runs, modes=api,
         compared="run_grid(EngineConfig(engine='torch', ...)) equal to the keyword call bit "
                  "for bit (lanes and stats); torch lanes against engine='batch' on the same "
                  "traces (device mode: the cells of q 0 and 1) and the scalar engine on the "
                  "first 8 lanes of each cell of q 0 and 1: integers exact, makespans rtol "
                  "1e-9")

    # ---- 31. devices= ------------------------------------------------- #
    t0 = time.monotonic()
    n_dev = torch.cuda.device_count()
    spellings = {"None": None, "1": 1, "all": "all", "[cuda:0, cuda:0]": [dev, dev]}
    ref_lanes = run_grid(sub, EngineConfig(trace_mode="host"), device=dev)
    ref_stats = run_grid(sub, EngineConfig(trace_mode="host", collect="stats"),
                         device=dev)
    shards = {}
    for name, devices in spellings.items():
        cfg = EngineConfig(trace_mode="host", devices=devices)
        got = run_grid(sub, cfg)
        lanes_agree(got, ref_lanes, f"devices={name} lanes")
        st = run_grid(sub, cfg.replace(collect="stats"))
        rel = stats_agree(st, ref_stats, f"devices={name} stats", 1e-12)
        shards[name] = {"devices": got.meta["devices"], "outer_iters": got.meta["outer_iters"],
                        "host_syncs": got.meta["host_syncs"], "max_rel_stats": rel}
    check(shards["[cuda:0, cuda:0]"]["devices"] == [str(dev)] * 2, "two shards on cuda:0")
    dev_two = run_grid(sub, EngineConfig(trace_mode="device", devices=[dev, dev]))
    lanes_agree(dev_two, run_grid(sub, EngineConfig(trace_mode="device"), device=dev),
                "devices=[cuda:0, cuda:0] device mode")
    emit("devices", seconds=time.monotonic() - t0, device_count=n_dev, spellings=shards,
         compared="per-lane results equal to devices=None (integers exact, makespans bit "
                  "for bit), per-cell stats integers exact and moments rtol 1e-12, host "
                  "trace mode; two shards on one card in device mode lane for lane")

    # ---- 32. BestPeriod on the card ----------------------------------- #
    t0 = time.monotonic()
    plat = platform(SEARCH_N)
    pred = PredictorModel(0.85, 0.82, window=300.0)
    calls, got = {}, []
    for name in SEARCH_FAMILIES:
        reset_counts(K)
        torch.cuda.synchronize()
        tc = time.monotonic()
        info = []
        pol = optimize(name, plat, pred, method="search", n_runs=SEARCH_RUNS,
                       seed=SEARCH_SEED, device=dev, info=info)
        torch.cuda.synchronize()
        wall = time.monotonic() - tc
        launches = counts(K)
        rec = info[0]
        iters = max(rec["outer_iters"], 1)
        for k in HOST_KERNELS:
            check(launches[k] == rec["outer_iters"],
                  f"BestPeriod {name}: {k} {launches[k]} launches in {iters} iterations")
        for k, n in launches.items():
            check(k in HOST_KERNELS or n == 0, f"BestPeriod {name}: {k} launched {n} times")
        check(rec["n_chunks"] == 1 and rec["devices"] == [str(dev)],
              f"BestPeriod {name}: {rec['n_chunks']} chunks on {rec['devices']}")
        got.append(pol)
        calls[name] = {"T_R": pol.T_R, "waste": pol.waste, "wall_s": wall,
                       "outer_iters": rec["outer_iters"], "host_syncs": rec["host_syncs"],
                       "ms_per_iter": 1e3 * wall / iters,
                       "launches": {k: launches[k] for k in HOST_KERNELS},
                       "split": {k: rec[k] for k in ("pack_s", "copy_s", "loop_s")}}
    card_s = time.monotonic() - t0
    tb = time.monotonic()
    batch = optimize(list(SEARCH_FAMILIES), plat, pred, method="search", n_runs=SEARCH_RUNS,
                     seed=SEARCH_SEED, engine="batch")
    batch_s = time.monotonic() - tb
    newton = optimize(list(SEARCH_FAMILIES), plat, pred, method="newton", device=dev)
    worst = 0.0
    for i, (name, pol) in enumerate(zip(SEARCH_FAMILIES, got)):
        check(pol.T_R == batch.T_R[i], f"BestPeriod {name}: T_R {pol.T_R} on the card, "
              f"{batch.T_R[i]} on the NumPy engine")
        rel = abs(pol.waste - batch.waste[i]) / batch.waste[i]
        worst = max(worst, rel)
        check(rel <= 1e-9, f"BestPeriod {name}: waste rel {rel}")
        calls[name]["T_R_over_newton"] = pol.T_R / float(newton.T_R[i])
        calls[name]["newton_T_R"] = float(newton.T_R[i])
    emit("best_period", seconds=time.monotonic() - t0, N=SEARCH_N, runs=SEARCH_RUNS,
         seed=SEARCH_SEED, lanes_per_call=SEARCH_RUNS * 10, card_s=card_s,
         batch_engine_s=batch_s, max_rel_waste_vs_batch=worst, calls=calls,
         note="optimize(families, platform(2**19), PredictorModel(0.85, 0.82, window=300), "
              "method='search', n_runs=100): one cell-multiplexed host-trace dispatch a "
              "family on the card; the same argmin T_R as engine='batch' on the same "
              "traces, waste rtol 1e-9; T_R_over_newton: the searched period over "
              "method='newton''s (a finding, not a gate)")

    # ---- 33. the paper's drivers on the card -------------------------- #
    t0 = time.monotonic()
    drivers = {}
    for name, mod in (("waste_curves", waste_curves), ("recall_precision", recall_precision)):
        reset_counts(K)
        tc = time.monotonic()
        on_card = driver_records(lambda m=mod: m.run(quick=False, engine="torch",
                                                     device=dev))
        wall = time.monotonic() - tc
        launched = sum(counts(K)[k] for k in HOST_KERNELS)
        check(launched > 0, f"{name}: no host-trace kernel launched on the card")
        on_host = driver_records(lambda m=mod: m.run(quick=False, engine="batch"))
        check(on_card == on_host, f"{name}: the card's records differ from the NumPy "
              "engine's")
        drivers[name] = {"records": len(on_card), "card_s": wall, "launches": launched}
    import contextlib
    import io

    reset_counts(K)
    tc = time.monotonic()
    with contextlib.redirect_stdout(io.StringIO()):
        card_lines = simulate_cluster.run(engine="torch", device=dev)
        host_lines = simulate_cluster.run(engine="batch")
    check(card_lines[:-1] == host_lines[:-1]
          and card_lines[-1].split("[sweep:")[0] == host_lines[-1].split("[sweep:")[0],
          "simulate_cluster: the card's table differs from the NumPy engine's")
    drivers["simulate_cluster"] = {"lines": len(card_lines), "seconds": time.monotonic() - tc,
                                   "launches": sum(counts(K)[k] for k in HOST_KERNELS),
                                   "table": card_lines[1:-1]}
    emit("paper_drivers", seconds=time.monotonic() - t0, drivers=drivers,
         compared="waste_curves and recall_precision at full size and simulate_cluster on "
                  "the card (torch engine, host traces) against engine='batch': every "
                  "emitted field equal at its printed rounding")


def main() -> int:
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    t_script = time.monotonic()
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    # ---- 1. environment ---------------------------------------------- #
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi)

    # ---- 2. build ------------------------------------------------------ #
    from repro_torch.kernels import build

    t0 = time.monotonic()
    logs = build.build_all()
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    regs = ptxas_report(logs.get("sim_step", ""))
    wkv_regs = ptxas_kernels(logs.get("rwkv6", ""), r"(wkv6_(?:chunk|token)_kernel)")
    emit("build", seconds=time.monotonic() - t0, built=sorted(logs),
         ptxas=ptxas, sim_step_registers=regs, wkv6_registers=wkv_regs)

    from repro_torch.kernels import sim_step as K

    # ---- 3. kernels against their plain versions, main-path lanes ------ #
    from repro_torch.experiments import GridSpec, paper_grid_cells, run_grid

    full = GridSpec(tuple(paper_grid_cells("full")), n_runs=RUNS_PER_CELL, seed=0)
    L = full.n_lanes
    err = {"masked_primitive_update": 0.0, "masked_stream_advance": 0.0}
    for li, (kind, param) in enumerate(LAWS):
        x = make_inputs(K, L, 100 + li, dev)
        got, want = run_prim(K, x, kind, param, False), run_prim(K, x, kind, param, True)
        for k in ("t", "saved", "unsaved", "pw", "flags", "ctr"):
            check(torch.equal(got[k], want[k]),
                  f"masked_primitive_update/{kind}: {k} differs from the plain version")
        u = int(ulp_dist(got["tm"], want["tm"]).max())
        check(u <= TM_ULPS, f"masked_primitive_update/{kind}: tm off by {u} ulp")
        check(int((x["prim"] != 0).sum()) > 0 and bool((got["flags"] & 1).any()),
              "primitive inputs exercised no fault")
        err["masked_primitive_update"] = max(err["masked_primitive_update"], max_abs_err(
            (got[k], want[k]) for k in ("t", "saved", "unsaved", "pw", "tm")))
        got, want = run_adv(K, x, kind, param, False), run_adv(K, x, kind, param, True)
        check(torch.equal(got["ctr"], want["ctr"]),
              f"masked_stream_advance/{kind}: ctr differs from the plain version")
        u2 = int(ulp_dist(got["tm"], want["tm"]).max())
        check(u2 <= TM_ULPS, f"masked_stream_advance/{kind}: tm off by {u2} ulp")
        err["masked_stream_advance"] = max(
            err["masked_stream_advance"], max_abs_err([(got["tm"], want["tm"])]))
        emit("kernel_check", law=kind, lanes=L, prim_tm_ulps=u, adv_tm_ulps=u2)

    # the walks on the main path's own lanes: iteration CAPTURE_ITER's three
    # walk calls of the full grid, replayed under every law, and under
    # per-lane laws (runs of 1000 lanes, the path's cells) on the indexed
    # variant, whose lanes of each law must be the single-law walks' bits
    t0 = time.monotonic()
    cap = capture_walks(full, dev, CAPTURE_ITER)
    for n in WALKS:
        err[n] = err[n + "[indexed]"] = 0.0
    walk_ulps = {}
    lane_laws = {k: torch.from_numpy(v).to(dev)
                 for k, v in K.sample_lane_laws(L, 120, RUNS_PER_CELL).items()}
    for kind, param in LAWS + (("indexed", lane_laws),):
        for name, c in cap.items():
            wrapper = "masked_strike_walk" if name == "strike" else "masked_prediction_walk"
            if kind == "indexed":
                wrapper += "[indexed]"
            got = walk_outputs(name, c.run(K, law=(kind, param)))
            want = walk_outputs(name, c.run(K, plain=True, law=(kind, param)))
            u, e = walk_diff(got, want, f"{wrapper} {name}/{kind}")
            walk_ulps[f"{name}/{kind}"] = u
            err[wrapper] = max(err[wrapper], e)
            if kind == "indexed":
                for li, sl in enumerate(K.SAMPLE_LAWS):
                    on = lane_laws["pick"] == li
                    single = walk_outputs(name, c.run(K, law=sl))
                    for k, w in single.items():
                        g = got[k]
                        if w.dtype.is_floating_point:
                            g, w = g.view(torch.int64), w.view(torch.int64)
                        check(torch.equal(g[on], w[on]), f"{name}: indexed {k} differs from "
                              f"the single-law walk on the {sl} lanes")
    work = {name: walk_work(c, walk_outputs(name, c.run(K, plain=True)), False)
            for name, c in cap.items()}
    emit("walk_check", seconds=time.monotonic() - t0, lanes=L, iteration=CAPTURE_ITER,
         has_migration="cancels.0" in cap["strike"].flat, work=work, tm_ulps=walk_ulps,
         compared=f"counters and fault counts equal to the plain version, dates within "
                  f"{TM_ULPS} ulp (nan and inf in place), under {[k for k, _ in LAWS]} and "
                  "per-lane laws; per-lane laws equal (0 ulp) to each law's single-law walk "
                  "on that law's lanes")

    # ---- 4. the main path: the full paper grid on the card ------------- #
    reset_counts(K)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    res = run_grid(full, device="cuda")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = counts(K)
    for name in ("masked_primitive_update", "masked_stream_advance"):
        check(launches[name] > 0, f"{name} was not launched on the main path")
    for name, n in launches.items():
        if name.endswith("[indexed]") or name.startswith(SILENT):
            check(n == 0, f"{name}: {n} launches on the single-law, fail-stop main path")
    meta = res.meta
    check(meta["device"].startswith("cuda"), f"main path ran on {meta['device']}")
    check(meta["outer_iters"] == OUTER_ITERS["full"],
          f"{meta['outer_iters']} outer iterations, {OUTER_ITERS['full']} before the walks")
    per_iter = path_launches(launches, meta, "")
    for c in res.cells:
        check(c.n_runs == RUNS_PER_CELL, f"{c.cell.label}: {c.n_runs} runs")
        check(0.0 < c.mean_waste < 1.0 and np.isfinite(c.ci95_waste),
              f"{c.cell.label}: waste {c.mean_waste}")
    anchors = {}
    for pk in ("p82r85", "p40r70"):
        y = res[f"{pk}/N65536/Young"].mean_waste
        e = res[f"{pk}/N65536/Exact"].mean_waste
        check(e < y, f"{pk}: ExactPrediction does not beat Young ({e} >= {y})")
        anchors[pk] = {"Young": y, "Exact": e}
    emit("main_path", cells=len(res.cells), runs_per_cell=RUNS_PER_CELL, lanes=L,
         seconds=wall, lanes_per_s=L / wall, outer_iters=meta["outer_iters"],
         host_syncs=meta["host_syncs"], n_chunks=meta["n_chunks"],
         launches={k: v for k, v in launches.items() if not k.endswith("[indexed]")},
         **per_iter, waste_N65536=anchors)

    # ---- 5. the card against the CPU, same port ------------------------ #
    val = GridSpec(tuple(paper_grid_cells("validation")), n_runs=8, seed=0)
    worst = card_vs_cpu(run_grid(val, device="cuda"), run_grid(val, device="cpu"))
    emit("card_vs_cpu", cells=len(val.cells), lanes=val.n_lanes,
         max_rel_float=worst, rtol=1e-9)

    # ---- 6. times at the main path's lane count ------------------------ #
    # The bound counts the faulted and masked lanes of these inputs; every
    # timed call runs on them (device_ms restores the copies before each
    # replay), and the timed calls' outputs are held against the plain
    # version's on the same inputs.
    x = make_inputs(K, L, 7, dev)
    xs = make_inputs(K, 128, 8, dev)
    f_kind, f_param = "exponential", 0.0
    want_prim = run_prim(K, x, f_kind, f_param, True)
    want_adv = run_adv(K, x, f_kind, f_param, True)
    n_fault = int(want_prim["flags"].bitwise_and(1).ne(0).sum())
    n_mask = int(x["mask"].sum())

    timing = {}
    for name, call, want, nbytes, ops in (
        ("masked_primitive_update", prim_call, want_prim,
         BYTES_PRIM * L + BYTES_PRIM_FAULTED * n_fault,
         OPS_PRIM * L + OPS_GAP * n_fault),
        ("masked_stream_advance", adv_call, want_adv,
         BYTES_ADV * L + BYTES_ADV_MASKED * n_mask, OPS_GAP * n_mask),
    ):
        n_copies = math.ceil(3 * L2_BYTES / nbytes)
        timing[name] = {
            "ms": timed(lambda c: call(K, c, f_kind, f_param), x, n_copies, want, name),
            "plain_ms": timed(lambda c: call(K, c, f_kind, f_param, plain=True), x,
                              n_copies, want, name + " (plain)"),
            "launch_floor_ms": timed(lambda c: call(K, c, f_kind, f_param), xs, 64),
            "host_call_ms": eager_ms(
                call(K, {k: v.clone() for k, v in x.items()}, f_kind, f_param), 200),
            "bytes": nbytes, "ops": ops, "copies": n_copies,
        }
    walk_times = time_walks(K, cap, None, False, "main path")
    emit("walk_timing", lanes=L, iteration=CAPTURE_ITER, times=walk_times,
         registers={n: regs.get(n) for n in WALKS},
         note="ms: device_ms over copies of the captured iteration's lanes restored "
              "before each replay; plain_ms: the plain walk issued eagerly (its loop "
              "conditions sync the host), CUDA events around the call")
    replaces = {
        "masked_primitive_update": "src/repro/kernels/sim_step.py:516",
        "masked_stream_advance": REPLACES_ADV,
    }
    kernels = [sim_step_entry(name, replaces[name], tm, launches[name], err[name],
                              lanes=L, faulted_lanes=n_fault, masked_lanes=n_mask,
                              registers=regs.get(name))
               for name, tm in timing.items()]
    kernels += walk_entries(walk_times, launches, err, regs, "", lanes=L,
                            iteration=CAPTURE_ITER)
    kernel_s = sum(k["launches"] * k["ms"] for k in kernels) / 1e3
    wrapper_s = sum(k["launches"] * k["host_call_ms"] for k in kernels) / 1e3
    emit("split", main_path_s=wall, kernel_device_s_est=kernel_s,
         kernel_share=kernel_s / wall, wrapper_host_s_est=wrapper_s,
         glue_s_est=wall - kernel_s - wrapper_s,
         launches_per_iter={k["name"]: k["launches"] / max(meta["outer_iters"], 1)
                            for k in kernels},
         note="estimates: main-path launches x the per-launch times of phase 6 (the "
              "walks at the captured iteration); glue: the wall time less both")
    kernels += checkpoint_phases(dev)
    kernels += serving_phases(dev, timing["masked_stream_advance"]["launch_floor_ms"])
    torch.cuda.empty_cache()  # the 7B path needs the card's memory
    kernels += rwkv_phases(dev, wkv_regs)
    torch.cuda.empty_cache()
    kernels += mixed_law_phases(dev, regs)
    analytic_phases(dev, res, smi)
    kernels += scenario_phases(dev, regs, launches)
    kernels += host_phases(dev, regs)
    t0 = time.monotonic()
    engine_phases(dev)
    emit("engine_phases", seconds=time.monotonic() - t0)
    emit("total", seconds=time.monotonic() - t_script)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
