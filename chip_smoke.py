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
width, 1 layer, f32); ``repro_torch.launch.serve`` on ``rwkv6-7b`` at
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
both trace modes; the paper's Tables 1-2 grid (the reference's 100
quick cells, with Weibull 0.5 superposed fresh-start traces, plus a
stationary family of 40) through ``run_cells`` (its cells from
``repro_torch.paper.sim_tables.build_cells``); and the four kernels'
times.

Then the engine API (phases 30-33, no kernel of their own): the 12-cell
sub-grid through ``run_grid(grid, EngineConfig(...))`` in both trace
modes, bit for bit the keyword call, and its lanes against the NumPy
engine and the scalar engine on the same traces; ``devices=`` as None,
1, "all" and the card named twice, lane for lane; BestPeriod
(``optimize(method="search")``, seven families, 100 runs at N = 2^17) on
the card against the NumPy engine, with each call's iterations, host
syncs and launches; the paper's drivers (``repro_torch.paper``) on the
card against the NumPy engine.

Then resumable campaigns (phases 34-37, no kernel of their own: the
campaign path launches the sim_step kernels of both trace modes): the full
paper grid through ``repro_torch.ft.run_campaign`` in 4 chunks of 27,000
lanes, with a snapshot every chunk (sync) and with the Young period of
the measured snapshot cost (async), bit-equal to each other and within
1e-12 of phase 4's one-chunk ``run_grid``, one primitive launch an outer
iteration; the campaign CLI (``python -m repro_torch.experiments.
campaign``) killed by SIGKILL at chunk 2 and resumed in a new process,
equal to the in-process campaign; synthetic chaos on the 12-cell
sub-grid (kills at chunks 1 and 3 resumed bit-equal, a device lost from
two shards on the card, a persistent engine failure degraded to the
NumPy engine); and, in two subprocesses (``chip_smoke.py
--campaign-fault oom|assert OUT``), a real ``torch.OutOfMemoryError``
under ``set_per_process_memory_fraction`` that halves the chunk, and a
real device-side assert that poisons the CUDA context, after which the
campaign retries, degrades and finishes on the host.

Then training under the paper's policy (phases 38-40, no kernel of their
own: the path launches the codec kernels on every save and disk
restore): SmolLM-135M's ``loss_fn``, every gradient leaf and one
``adamw_update`` on the card against the CPU (full width, 2 layers, f32,
dense and chunked attention), no flash launch in a training step, and a
backward through ``attn_impl="pallas"`` that raises; then
``repro_torch.launch.train`` at full width (15 of its 30 layers since PR
30 cut the script's time; bf16 compute, 8 x 1024 tokens) under ``FaultTolerantExecutor`` on the wall clock, through
``AsyncCheckpointer(CheckpointStore(codec="int8"))`` with a
``BuddyMemoryCheckpoint`` as the first restore tier, once fault-free and
once with faults from a seeded trace under the paper-accurate predictor,
under ``torch.use_deterministic_algorithms``: the loss falls, every step
before the first disk restore has the fault-free run's loss bit for bit
and the last step's is within a stated tolerance, 30 quantize launches a
save and 30 dequantize launches a disk restore (step ms, tokens/s, C,
the period, the ledger against ``waste_exact``, peak memory; a step's
forward / backward / update split and its device kernels); and the train
CLI in a subprocess on the card.  ``python3 chip_smoke.py --only train``
runs the environment, the build and these phases alone.

Then the dense and MoE families (phases 41-44, no kernel of their own:
their serving paths launch the two attention kernels): both attention
kernels against their plain versions at every new shape (head dim 128
with query groups 8, 4 and 7, head dim 64 with group 7; Qwen3-30B-A3B,
qwen2-0.5b, granite-8b, qwen2-72b, Arctic-480B), timed beside their
bounds, plain versions and ``scaled_dot_product_attention``;
Qwen3-30B-A3B at full width and 1 layer on the card
against the port on the CPU, in f32 (routing equal) and bf16 (routing differences counted,
the card then routed as the CPU), and a repeated prefill bit-equal;
Qwen3-30B-A3B at full width (8 of its 48 layers since the training
phases 49-52 took the script's time, now 4; 48, 61 GB of bf16
weights, fit; a prefill and the decode step's split at 12 layers)
through ``serve()`` (8 x 1024 prompt tokens, 128 generated, a snapshot
every 16), fault-free and faulted with equal tokens, a flash launch a
layer a prefill and a decode call a layer a step; then qwen2-0.5b at
full width and 12 of its 24 layers, granite-8b at 6 of its 36 layers,
qwen2-72b at 4 of its 80 layers and Arctic-480B at 2 of its 35 (32
generated tokens, fault-free), served the same way.  ``python3
chip_smoke.py --only families`` runs the environment, the build and these
phases alone.

Then Mamba and the frontend families (phases 45-48): the selective-scan
kernel (``csrc/mamba_scan.cu``, Mamba's ``lax.scan`` in the reference)
against its plain version at Jamba-1.5-Large's prefill and decode shapes
and on edge cases (one token, a nonzero initial state, state size 8, the
state written in place: final state bit-equal, y within a stated
tolerance), libdevice's ``expf`` against ``torch.exp`` bit for bit, the
kernel timed beside its bound, its f32 issue floor, its launch floor and
its plain version, and both attention kernels at llava-next's S = 1600
(group 4, head dim 128) and musicgen's S = 1088 (group 1, head dim 64);
one Mamba block at full width and Jamba at a width cut (its 8 pattern
layers, 16 experts, routing compared first) on the card against the port
on the CPU, in f32; Jamba at full width through ``serve()`` (1 of its 9
repeats, 8 of its 16 experts; 8 x 1024 prompt tokens, 128 generated),
fault-free and faulted with equal tokens, 7 scan launches and 1 flash
launch a prefill, 7 scan launches and 1 decode call a step; then
llava-next and musicgen at full width and half depth (16 of 32 and 24 of 48
layers, to keep the script inside its time limit) with their 576- and
64-row frontend prefixes (32 generated tokens, fault-free and faulted,
equal tokens; a tensor-core flash launch a layer a prefill).  ``python3 chip_smoke.py
--only hybrid`` runs the environment, the build and these phases alone.

Then training the recurrent families (phases 49-52): the WKV and
selective-scan backward kernels against their plain versions at RWKV6-7B's
and Jamba's training shapes and odd cases (ds0 / dh0 bit for bit, the same
bits twice) and timed; RWKV6-7B at full width with 1 layer and Jamba's
width cut, loss and every gradient leaf card against CPU (and the kernels
against the plain recurrences on the card); ``train()`` on RWKV6-7B (2
layers) and Jamba-1.5-Large (2 layers, 2 of 16 experts) at full width, 8 x
1024 tokens, fault-free and under faults (paper-accurate predictor, int8
store behind the memory tier): step ms, forward / backward / AdamW ms, the
recurrence kernels' launches, peak memory, ``c_block`` / ``c_full``, the
losses bit-equal up to the first disk restore; remat none / full / dots on
the RWKV6 cut, bit-equal.  ``python3 chip_smoke.py --only ssm_train`` runs
the environment, the build and these phases alone.

Then the distributed layer (phase 53), on Qwen3-30B-A3B at full width (128
experts, top-8): in a subprocess with a world-size-1 NCCL process group
(file rendezvous) and the (1, 1) ``(data, model)`` mesh, 2 of its 48
layers, the sharded train step (ZeRO-1 moment specs, f32 AdamW) for two
steps of 8 x 1024 tokens, bit-equal to the unsharded step (losses,
parameters), a sharded prefill (one flash launch a layer,
bit-equal to the unsharded prefill), ``dp_allreduce_int8`` bit-equal to the
quantize / dequantize round trip, and one MoE layer's expert leaves and
their moments saved through the int8 store with ``shardings=`` and restored
onto the mesh (bit-equal to the coded round trip, the codec launches
counted, ``c_block`` / ``c_full``); then, with no process group, one MoE
layer's output as 8 expert-parallel shares (16 experts each) run in turn
and summed in rank order against ``moe_apply`` (bf16 and f32), each
share's device ms beside ``moe_apply``'s.  ``python3 chip_smoke.py --only
parallel`` runs the environment, the build and this phase alone.

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
#: rows of the timed table that the CPU also solves, to hold the card to
#: (was all NEWTON_CELLS: a 7.6 s solve on the CPU; each row is solved
#: alone)
NEWTON_CPU_CELLS = 8192
#: phase 23: the reference validation suite's contract (runs, seed, alpha)
VALIDATION_RUNS, VALIDATION_SEED, VALIDATION_ALPHA = 200, 11, 0.01
#: phase 25: the scenario grid's seed (the reference benchmark's
#: two_level_silent_cells48 grid), the fractional trust levels, and the
#: runs a cell of the two-law fused-vs-per-family case
SCENARIO_SEED = 9
TRUST_QS = (0.3, 0.5)
SCENARIO_MIXED_RUNS = 8
#: phase 24: the trust-coin walks' sampled horizons are capped at the lane's
#: clock plus this span (was uncapped: 12 x 8 days for 85% of the lanes, so
#: the q = 0 lanes walked ~4,000 faults to their stream's end, ~35,000
#: eager steps of the plain walks in all; ~2,100 now).  Every mode, variant
#: and q is still walked to its end.
TRUST_HORIZON_SPAN = 4 * 86400.0

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
#: phase 16's depth (cut to keep the script inside its time limit)
RWKV_CPU_LAYERS = 1
RWKV_CARD_CPU_TOL = {"prefill": 1e-4, "decode_same_cache": 1e-4, "decode_own_cache": 2e-2}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


#: the script's start on the host's monotonic clock: every line's "at_s"
#: counts from it, so phases that state no seconds of their own can be timed
#: from the lines before and after them
T_START = time.monotonic()


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw, "at_s": time.monotonic() - T_START}), flush=True)


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
    call of ``fn``, counted in a ``torch.profiler`` trace of the card.

    ``fn`` runs twice: once in a warm-up cycle whose events are discarded,
    then once in the active cycle that is counted, with a host pause on
    each side of the call.  The profiler drops device records that fall
    outside its capture window by its own clock, and a trace that starts
    cold can lose the first record of its session: an H100 run counted a
    decode call's combine kernel but not the split kernel launched just
    before it.  The warm-up cycle and the pauses keep the call's kernels
    inside the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            time.sleep(0.02)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
            prof.step()
    return {n: sum(n in e.name for e in prof.events()) for n in names}


def kernel_split(fn, reps: int = 10) -> list:
    """The device kernels of ``reps`` calls of ``fn`` in a ``torch.profiler``
    trace: for each kernel, by name, its launches a call and its mean ms
    over the launches the trace recorded (the profiler's averages), and what
    the exported trace records of its launch (grid, block, registers a
    thread, shared memory a block, the estimated occupancy; None where the
    trace has no record of it).  Late in this script the profiler recorded
    none of a few short calls' kernels, though it recorded a training
    step's, and a cold trace can drop its first records: so a small kernel
    opens the session and ``fn`` runs ``reps`` times, and a kernel recorded
    fewer than ``reps / 2`` times is left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(0.02)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    launch = {e["name"]: e.get("args", {}) for e in events if e.get("cat") == "kernel"}
    out = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        if not us or 2 * e.count < reps:
            continue
        a = launch.get(e.key, {})
        out.append({"kernel": e.key, "launches": round(e.count / reps), "ms": us / 1e3 / e.count,
                    "grid": a.get("grid"), "block": a.get("block"),
                    "registers": a.get("registers per thread"),
                    "shared_bytes": a.get("shared memory"),
                    "occupancy_pct": a.get("est. achieved occupancy %")})
    return out


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
    # (full width, RWKV_CPU_LAYERS layers, f32; the bonus u, the decays w0, the token-shift
    # lerps mu and the group-norm scale ln drawn from a seed, with the CPU
    # tests' laws, since the init leaves them zero or constant; the CPU side
    # on one thread)
    t0 = time.monotonic()
    small = dataclasses.replace(cfg, num_layers=RWKV_CPU_LAYERS)
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
    emit("rwkv_card_vs_cpu", seconds=time.monotonic() - t0, layers=RWKV_CPU_LAYERS,
         d_model=small.d_model,
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
    cargs, n_cpu = A.newton_inputs({k: v[:NEWTON_CPU_CELLS] for k, v in big.items()},
                                   device="cpu")
    tc = time.perf_counter()
    cout = KA.newton_policy(*cargs)
    cpu_s = time.perf_counter() - tc
    big_rel = 0.0
    for g, c in zip(out, cout):
        check(np.isfinite(g[:n_big].cpu().numpy()).all(),
              "newton (65,536 cells): non-finite on the card")
        g, c = g[:n_cpu].cpu().numpy(), c[:n_cpu].numpy()
        big_rel = max(big_rel, float(np.max(np.abs(g - c) / np.maximum(np.abs(c), 1e-300))))
    check(big_rel <= NEWTON_RTOL, f"newton ({n_cpu} of its cells): card vs CPU rel {big_rel}")
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
         card_ms_samples=ms, cpu_s=cpu_s, cpu_cells=n_cpu,
         cpu_threads=torch.get_num_threads(),
         big_card_vs_cpu_rel=big_rel, device_kernels_per_solve=len(dev_events),
         distinct_kernels=len({e.name for e in dev_events}),
         host_syncs_in_solve=0, user_calls=user_calls, bracket_loop=loop_ms,
         nvidia_smi=smi,
         note="card_ms: CUDA events around one solve, median of 5 after a warm-up; "
              "cpu_s: one solve of the first cpu_cells rows on the CPU, held to the card's "
              "within rtol; host_syncs_in_solve: the solve ran under "
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
    t_trust = time.monotonic()
    x = K.lane_state_tensors(K.sample_walk_state(L, 130), dev)
    x["horizon"] = torch.minimum(x["horizon"], x["t"] + TRUST_HORIZON_SPAN)
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
    emit("scenario_check", seconds=time.monotonic() - t0, silent_s=t_trust - t0,
         trust_s=time.monotonic() - t_trust, trust_horizon_span_s=TRUST_HORIZON_SPAN,
         lanes=L, iteration=CAPTURE_ITER, silent_work=silent_work, trust_work=trust_calls, ulps=ulps,
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
#: phase 29: the reference's Tables 1-2 benchmark in its quick form: 16
#: runs a cell (was 30, its full form) on its 100 quick cells (was its 120
#: full ones: the 20 more, Weibull 0.5 superposed at N 2^19, took ~11,000
#: of the phase's ~11,200 outer iterations, the other cells ~3,300 at most)
TABLES_RUNS, TABLES_SEED = 16, 100


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


class SlabSpy:
    """Inside ``with``: torch_sim's slab-walk wrappers are wrapped, and the
    arguments of outer iteration ``at``'s calls of the walks ``names`` (of
    "skip", "strike", "silent") are kept as they were before each call, in
    ``self.cap``: {name: :class:`SlabCall`}."""

    def __init__(self, at: int, names):
        from repro_torch.core import torch_sim as PT

        self.PT, self.at, self.names, self.cap = PT, at, names, {}
        self.real = {n: getattr(PT, n) for n in SLAB_WALKS}

    def __enter__(self):
        seen = dict.fromkeys(("skip", "strike", "silent"), 0)

        def spy(name, fn):
            def wrapped(*args, **kw):
                if name in self.names and seen[name] == self.at:
                    self.cap[name] = SlabCall(name, args, kw)
                seen[name] += 1
                return fn(*args, **kw)

            return wrapped

        for short, n in zip(("skip", "strike", "silent"), SLAB_WALKS):
            setattr(self.PT, n, spy(short, self.real[n]))
        return self

    def __exit__(self, *exc):
        for n, fn in self.real.items():
            setattr(self.PT, n, fn)
        if exc[0] is None:
            check(sorted(self.cap) == sorted(self.names),
                  f"captured slab walks {sorted(self.cap)}")


def capture_slab_walks(layout, dev, at: int, names) -> dict:
    """Run ``layout``'s host traces on the card for ``at + 1`` outer
    iterations under a :class:`SlabSpy`: {name: :class:`SlabCall`}."""
    with SlabSpy(at, names) as spy:
        try:
            spy.PT.simulate_batch_torch(layout.work_c, layout.plats_c, layout.strats_c,
                                        layout.traces, cell_index=layout.cidx, device=dev,
                                        max_iters=at + 1)
            raise SmokeFailure(f"the grid finished within {at + 1} iterations")
        except RuntimeError as e:
            if "did not converge" not in str(e):
                raise
    return spy.cap


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
    (``repro_torch.paper.sim_tables.build_cells(quick=True)``, the
    reference benchmark's 100 quick cells), plus the full grid's Weibull
    0.5 family again with stationary components (both platform sizes):
    40 more."""
    from dataclasses import replace

    from repro_torch.paper.sim_tables import build_cells

    stationary = [replace(c, stationary=True, label=c.label.replace("-fresh", "-stationary"))
                  for c in build_cells(quick=False) if c.n_components]
    return build_cells(quick=True) + stationary


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
    gen_s = time.monotonic() - t1
    cap = capture_slab_walks(layout, dev, CAPTURE_ITER, ("skip", "strike"))
    check("Fcancel" in cap["strike"].kw, "the full grid's strike walk carries no cancel marks")

    def check_slab_walks(names):
        for name in names:
            c = cap[name]
            wrapper = SLAB_WALKS[("skip", "strike", "silent").index(name)]
            g, w = c.run(K), c.run(K, plain=True)
            for k in w:
                check(torch.equal(f64_bits(g[k]), f64_bits(w[k])),
                      f"{wrapper}: {k} differs from the plain version")
            err[wrapper] = max_abs_err((g[k], w[k]) for k in w if w[k].dtype == torch.float64)
            work[wrapper] = c.work(w)
            check(work[wrapper]["steps"] > 0, f"{wrapper}: the captured call walks no lane")

    check_slab_walks(("skip", "strike"))
    check_s = time.monotonic() - t0

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

    # the scenario grid in host mode: the silent slab walk's path, its
    # iteration CAPTURE_ITER's silent walk kept for phase 26's check (the
    # path's own traces: no second generation of them)
    reset_counts(K)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with SlabSpy(CAPTURE_ITER, ("silent",)) as spy:
        sres = run_grid(scen, device="cuda", trace_mode="host")
    torch.cuda.synchronize()
    swall = time.monotonic() - t0
    cap.update(spy.cap)
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
    t0 = time.monotonic()
    check_slab_walks(("silent",))
    emit("host_check", seconds=check_s + time.monotonic() - t0, lanes=L,
         faulted_lanes=n_fault, iteration=CAPTURE_ITER, host_gen_s_capture_layouts=gen_s,
         slab_shapes={n: list(c.args[3 if n == "skip" else -1].shape) for n, c in cap.items()},
         cancel_lanes=int(cap["strike"].kw["can"].sum()), work=work,
         compared="trace-fed primitive update (no stream) on 108,000 sampled lanes and the "
                  "slab walks on iteration 40 of the host-mode full grid (skip, strike with "
                  "cancel marks) and scenario grid (silent, captured on its host path): "
                  "every output bit-equal to the plain version")

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
    check(len(tres.cells) == len(cells) and all(np.isfinite(c.mean_waste) and 0.0 < c.mean_waste < 1.0
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
         note="repro_torch.paper.sim_tables.build_cells(quick=True) (the reference "
              "benchmark's quick grid) plus the full grid's Weibull 0.5 "
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
#: paper's 100 runs, the default period grid: 1,000 lanes a call).  N was
#: 2**19: 5,408 outer iterations over the seven calls, 25.4 s of host-bound
#: loop; 2**17 takes ~1,000
SEARCH_FAMILIES = ("young", "daly", "exact", "instant", "nockpt", "withckpt", "migration")
SEARCH_N, SEARCH_RUNS, SEARCH_SEED = 2**17, 100, 0
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
         note=f"optimize(families, platform({SEARCH_N}), PredictorModel(0.85, 0.82, "
              "window=300), "
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


#: phases 34-35: the full grid's campaign chunk (4 chunks) and the MTBF of
#: the machine running the campaign (the mu of its snapshot period)
CAMPAIGN_CHUNK = 27000
CAMPAIGN_MTBF = 3600.0
#: phases 36-37: the 12-cell sub-grid's chunk (4 chunks of its 2,400
#: lanes) and the chunk at whose boundary the real sticky error is raised
CHAOS_CHUNK = 600
ASSERT_AT_CHUNK = 2
#: phase 35: the CLI's campaign, the full grid's first cells (its 27
#: smallest-platform cells, N 2^14-2^16 at the first predictor) in 4
#: chunks, killed at chunk 2 (was the whole grid, 108 cells in 4 chunks of
#: CAMPAIGN_CHUNK: ~2,500 outer iterations over its two processes, ~230 now)
CLI_CELLS, CLI_CHUNK = 27, 7000
#: the 12-column campaign accumulator: moment columns and count columns
def campaign_spy():
    """Route the campaign's engine calls through a spy that keeps each
    call's ``info`` (outer iterations, host syncs, slab bytes).  Returns
    the list of records and the function that restores the module."""
    from repro_torch.ft import campaign as CM

    real = CM.simulate_batch_torch
    calls = []

    def spy(*args, **kw):
        info = {}
        out = real(*args, info=info, **kw)
        calls.append(info)
        return out

    CM.simulate_batch_torch = spy
    return calls, lambda: setattr(CM, "simulate_batch_torch", real)


def timed_snapshots(runner) -> list:
    """Time each snapshot of ``runner``'s store: the host copy
    (``snapshot``) and the disk write (``write``, on the drain thread when
    snapshots are asynchronous).  Returns the list of records."""
    store = runner.store
    snap_fn, write_fn = store.snapshot, store.write
    snaps = []

    def snapshot(tree, prev_tree=None):
        t = time.monotonic()
        s = snap_fn(tree, prev_tree)
        snaps.append({"snapshot_s": time.monotonic() - t})
        return s

    def write(step, snap):
        # the next snapshot waits for this drain, so snaps[-1] is this one
        t = time.monotonic()
        m = write_fn(step, snap)
        snaps[-1].update(step=step, write_s=time.monotonic() - t)
        return m

    store.snapshot, store.write = snapshot, write
    return snaps


def device_assert_chaos(at: int):
    """A ``ChaosInjector`` that, at the first torch attempt of chunk
    ``at``, indexes a card tensor out of bounds and synchronizes: a real
    device-side assert, which leaves the process's CUDA context unusable."""
    from dataclasses import dataclass

    import torch
    from repro_torch.ft import ChaosInjector

    @dataclass
    class DeviceAssertChaos(ChaosInjector):
        assert_at: int = 0

        def at_chunk_boundary(self, chunk, *, incarnation=0, attempt=0, engine="torch"):
            if chunk == self.assert_at and attempt == 0 and engine == "torch":
                x = torch.zeros(4, device="cuda")
                x[torch.tensor([1 << 20], device="cuda")] += 1.0
                torch.cuda.synchronize()
            super().at_chunk_boundary(chunk, incarnation=incarnation, attempt=attempt,
                                      engine=engine)

    return DeviceAssertChaos(assert_at=at)


def campaign_fault_child(kind: str, out: str) -> int:
    """Phase 37's subprocesses (``chip_smoke.py --campaign-fault KIND
    OUT``): a campaign on the card that meets a real fault, its record
    written to ``OUT`` as JSON with its comparison made here.  ``oom``: the
    validation preset in host mode, once uncapped and once under a memory
    cap between the halved chunk's need and the whole chunk's, set from
    the chunk's slab bytes and the uncapped run's peak of live bytes; the
    capped run against the uncapped one.  ``assert``: the 12-cell sub-grid
    in host mode, undisturbed and then with a device-side assert at chunk
    ``ASSERT_AT_CHUNK``; the second against the first."""
    sys.path.insert(0, str(SRC))
    import torch
    from repro_torch.core import EngineConfig
    from repro_torch.experiments import GridSpec, paper_grid_cells
    from repro_torch.ft import CampaignConfig, CampaignRunner

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)  # the context and its allocator
    rec = {"kind": kind}
    with tempfile.TemporaryDirectory() as tmp:
        if kind == "oom":
            grid = GridSpec(tuple(paper_grid_cells("validation")), n_runs=VALIDATION_RUNS,
                            seed=VALIDATION_SEED)
            cfg = EngineConfig(engine="torch", trace_mode="host", collect="stats",
                               chunk_lanes=grid.n_lanes)
            calls, restore = campaign_spy()
            try:
                torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.monotonic()
                free = CampaignRunner(grid, CampaignConfig(
                    ckpt_dir=os.path.join(tmp, "free"), ckpt_period=0.0,
                    async_snapshots=False), cfg, device=dev)
                want = free.run()
                free_s = time.monotonic() - t0
                peak = torch.cuda.max_memory_allocated(dev)
                slab = calls[0]["slab_bytes"]
                torch.cuda.empty_cache()
                total = torch.cuda.get_device_properties(dev).total_memory
                # the whole chunk's live bytes reach `peak`, its slabs
                # `slab` of them; a half's slabs are at most slab / 2 (its
                # widest lane is no wider), so a cap an eighth of the slabs
                # below the peak fails the whole chunk and fits either half
                cap = peak - slab // 8
                torch.cuda.set_per_process_memory_fraction(cap / total, dev)
                torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.monotonic()
                capped = CampaignRunner(grid, CampaignConfig(
                    ckpt_dir=os.path.join(tmp, "capped"), ckpt_period=0.0,
                    async_snapshots=False), cfg, device=dev)
                res = capped.run()
                rec.update(lanes=grid.n_lanes, cells=len(grid.cells), slab_bytes=slab,
                           peak_allocated_bytes=peak, cap_bytes=cap, total_bytes=total,
                           capped_peak_allocated_bytes=torch.cuda.max_memory_allocated(dev),
                           free_s=free_s, capped_s=time.monotonic() - t0,
                           chunks=[c["n_chunks"] for c in calls],
                           slab_bytes_per_call=[c["slab_bytes"] for c in calls],
                           max_rel_vs_uncapped=stats_agree(res, want, "real OOM vs uncapped",
                                                           1e-9))
            finally:
                restore()
        else:
            sub = host_sub_grid()
            cfg = EngineConfig(engine="torch", trace_mode="host", collect="stats",
                               chunk_lanes=CHAOS_CHUNK)
            want = CampaignRunner(sub, CampaignConfig(
                ckpt_dir=os.path.join(tmp, "host"), ckpt_period=0.0,
                async_snapshots=False), cfg, device=dev).run()
            t0 = time.monotonic()
            res = CampaignRunner(sub, CampaignConfig(
                ckpt_dir=os.path.join(tmp, "assert"), ckpt_period=0.0, async_snapshots=False,
                chaos=device_assert_chaos(ASSERT_AT_CHUNK)), cfg, device=dev).run()
            rec.update(seconds=time.monotonic() - t0,
                       max_rel_vs_host=stats_agree(res, want, "device-side assert vs host",
                                                   1e-12))
        rec.update(engine=res.engine, campaign=res.meta["campaign"])
    with open(out, "w") as f:
        json.dump(rec, f)
    return 0


def campaign_phases(dev, main_res, main_wall: float) -> None:
    """Phases 34-37: resumable campaigns (no kernel of their own: the
    campaign path launches the sim_step kernels of both trace modes).  The
    full grid through ``run_campaign`` in 4 chunks, twice, against phase
    4's one-chunk ``run_grid`` (``main_res``, ``main_wall`` seconds); the
    CLI killed by SIGKILL and resumed; synthetic chaos on the 12-cell
    sub-grid (kills, a device loss on two shards, a persistent engine
    failure that degrades torch to the NumPy engine); and two real faults
    in subprocesses, a CUDA out-of-memory and a device-side assert."""
    import torch
    from repro_torch.core import EngineConfig
    from repro_torch.experiments import GridSpec, paper_grid_cells
    from repro_torch.ft import (CampaignConfig, CampaignKilled, CampaignRunner,
                                ChaosInjector, RetryPolicy)
    from repro_torch.kernels import sim_step as K

    nosleep = RetryPolicy(sleep=lambda s: None)

    def campaign(grid, cfg, tmp, name, device=dev, **camp):
        return CampaignRunner(grid, CampaignConfig(ckpt_dir=os.path.join(tmp, name), **camp),
                              cfg, device=device).run()

    def kinds(res):
        return [e["kind"] for e in res.meta["campaign"]["events"]]

    # ---- 34. the full grid as a campaign on the card ------------------- #
    t0 = time.monotonic()
    full = GridSpec(tuple(paper_grid_cells("full")), n_runs=RUNS_PER_CELL, seed=0)
    cfg = EngineConfig(engine="torch", trace_mode="device", collect="stats",
                       chunk_lanes=CAMPAIGN_CHUNK)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, camp in (("period_0_sync", dict(ckpt_period=0.0, async_snapshots=False)),
                           ("young_async", dict(ckpt_period=None, mtbf=CAMPAIGN_MTBF,
                                                async_snapshots=True))):
            runner = CampaignRunner(full, CampaignConfig(ckpt_dir=os.path.join(tmp, name),
                                                         **camp), cfg, device=dev)
            snaps = timed_snapshots(runner)
            calls, restore = campaign_spy()
            reset_counts(K)
            try:
                torch.cuda.synchronize()
                tc = time.monotonic()
                res = runner.run()
                torch.cuda.synchronize()
                wall = time.monotonic() - tc
            finally:
                restore()
            launches = counts(K)
            info = res.meta["campaign"]
            iters = [c["outer_iters"] for c in calls]
            check(not info["engine_degraded"] and res.engine == "torch",
                  f"campaign {name}: degraded")
            check(len(calls) == -(-full.n_lanes // CAMPAIGN_CHUNK),
                  f"campaign {name}: {len(calls)} engine calls")
            check(launches["masked_primitive_update"] == sum(iters),
                  f"campaign {name}: {launches['masked_primitive_update']} primitive "
                  f"launches in {sum(iters)} outer iterations")
            for k, n in launches.items():
                if k.endswith("[indexed]") or k.endswith("[host]") or "slab" in k:
                    check(n == 0, f"campaign {name}: {k} launched {n} times")
            async_ = camp["async_snapshots"]
            runs[name] = (res, {
                "seconds": wall, "over_run_grid": wall / main_wall,
                "chunks": len(calls), "outer_iters_per_chunk": iters,
                "outer_iters": sum(iters), "host_syncs": sum(c["host_syncs"] for c in calls),
                "launches": {k: v for k, v in launches.items() if v},
                "cursor_launches_per_iter": sum(launches[n] for n in CURSOR_KERNELS)
                / max(sum(iters), 1),
                "n_snapshots": info["n_snapshots"],
                "snapshot_cost_est_s": info["snapshot_cost_est_s"],
                "snapshot_period_s": info["snapshot_period_s"],
                "snapshots": [{"step": s.get("step"),
                               "c_block": s["snapshot_s"] if async_
                               else s["snapshot_s"] + s.get("write_s", 0.0),
                               "c_full": s["snapshot_s"] + s.get("write_s", 0.0)}
                              for s in snaps],
            })
    a, b = runs["period_0_sync"][0], runs["young_async"][0]
    check(runs["period_0_sync"][1]["n_snapshots"] == 4, "period 0: a snapshot a chunk")
    stats_agree(b, a, "campaign young vs period 0", 0.0)
    rel = stats_agree(a, main_res, "campaign vs run_grid", 1e-12)
    emit("campaign_path", seconds=time.monotonic() - t0, cells=len(full.cells),
         lanes=full.n_lanes, chunk_lanes=CAMPAIGN_CHUNK, run_grid_s=main_wall,
         runs={k: v[1] for k, v in runs.items()}, max_rel_vs_run_grid=rel,
         compared="the two campaigns bit-equal; against phase 4's one-chunk run_grid "
                  "integers exact, moments rtol 1e-12; one masked_primitive_update "
                  "launch an outer iteration; c_block: the chunk loop's stall, c_full: "
                  "until written (sync: both the whole save)")

    # ---- 35. the CLI killed by SIGKILL, resumed ------------------------ #
    t0 = time.monotonic()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cli = [sys.executable, "-m", "repro_torch.experiments.campaign"]
    args = ["--preset", "full", "--limit-cells", str(CLI_CELLS), "--n-runs",
            str(RUNS_PER_CELL), "--seed", "0", "--chunk-lanes", str(CLI_CHUNK),
            "--ckpt-period", "0"]
    with tempfile.TemporaryDirectory() as tmp:
        d, out = os.path.join(tmp, "k"), os.path.join(tmp, "resumed.json")
        tc = time.monotonic()
        killed = subprocess.run(cli + args + ["--ckpt-dir", d, "--chaos-kill-at", "2",
                                              "--chaos-kill-mode", "sigkill"],
                                env=env, capture_output=True, text=True, timeout=600)
        kill_s = time.monotonic() - tc
        check(killed.returncode in (-9, 137),
              f"campaign CLI kill: rc {killed.returncode}: {killed.stderr[-2000:]}")
        left = sorted(p for p in os.listdir(d) if p.startswith("step_"))
        tc = time.monotonic()
        resumed = subprocess.run(cli + ["--resume", d, "--out", out], env=env,
                                 capture_output=True, text=True, timeout=600)
        resume_s = time.monotonic() - tc
        check(resumed.returncode == 0,
              f"campaign CLI resume: rc {resumed.returncode}: {resumed.stderr[-2000:]}")
        with open(out) as f:
            got = json.load(f)
        # the same campaign uninterrupted, in this process
        ref = campaign(GridSpec(tuple(paper_grid_cells("full")[:CLI_CELLS]),
                                n_runs=RUNS_PER_CELL, seed=0),
                       cfg.replace(chunk_lanes=CLI_CHUNK), tmp, "ref", ckpt_period=0.0,
                       async_snapshots=False)
    keys = ("label", "mean_waste", "mean_makespan", "mean_faults")
    check(ref.meta["campaign"]["n_snapshots"] == 4 and len(ref.cells) == CLI_CELLS,
          f"campaign CLI: the reference ran {ref.meta['campaign']['n_snapshots']} chunks")
    check([[r[k] for k in keys] for r in got["cells"]]
          == [[c.cell.label, c.mean_waste, c.mean_makespan, c.mean_faults] for c in ref.cells],
          "campaign CLI: the resumed cells differ from the uninterrupted campaign")
    info = got["meta"]["campaign"]
    check(info["incarnation"] >= 1, f"campaign CLI: incarnation {info['incarnation']}")
    emit("campaign_sigkill", seconds=time.monotonic() - t0, kill_rc=killed.returncode,
         kill_s=kill_s, snapshots_left=left, resume_s=resume_s,
         incarnation=info["incarnation"], n_snapshots=info["n_snapshots"],
         events=info["events"], stdout=resumed.stdout.strip().splitlines(),
         cells=CLI_CELLS, chunk_lanes=CLI_CHUNK,
         compared="label, mean_waste, mean_makespan, mean_faults equal to the same grid's "
                  "uninterrupted period-0 campaign in this process")

    # ---- 36. synthetic chaos on the 12-cell sub-grid ------------------- #
    t0 = time.monotonic()
    sub = host_sub_grid()
    dcfg = EngineConfig(engine="torch", trace_mode="device", collect="stats",
                        chunk_lanes=CHAOS_CHUNK)
    hcfg = dcfg.replace(trace_mode="host")
    cases = {}
    with tempfile.TemporaryDirectory() as tmp:
        base = campaign(sub, dcfg, tmp, "base", ckpt_period=0.0, async_snapshots=False)
        # (a) raise-mode kills, sync snapshots
        for k in (1, 3):
            try:
                campaign(sub, dcfg, tmp, f"kill{k}", ckpt_period=0.0, async_snapshots=False,
                         chaos=ChaosInjector(kill_at=(k,)))
                check(False, f"campaign chaos: the kill at chunk {k} did not fire")
            except CampaignKilled:
                pass
            res = campaign(sub, dcfg, tmp, f"kill{k}", ckpt_period=0.0,
                           async_snapshots=False)
            stats_agree(res, base, f"campaign chaos kill {k}", 0.0)
            resumes = [e for e in res.meta["campaign"]["events"] if e["kind"] == "resume"]
            check(len(resumes) == 1 and resumes[0]["chunk"] == k,
                  f"campaign chaos kill {k}: resume events {resumes}")
            cases[f"a_kill_{k}"] = {"events": res.meta["campaign"]["events"]}
        # (b) two shards on the card, one lost at chunk 2
        res = campaign(sub, dcfg.replace(devices=[dev, dev]), tmp, "devloss",
                       device=None, ckpt_period=0.0, async_snapshots=False,
                       retry=nosleep, chaos=ChaosInjector(device_loss_at=(2,)))
        info = res.meta["campaign"]
        check("devices_shrunk" in kinds(res) and info["n_devices_final"] == 1,
              f"campaign chaos device loss: {kinds(res)}, {info['n_devices_final']} devices")
        rel_b = stats_agree(res, base, "campaign chaos device loss", 1e-12)
        cases["b_device_loss"] = {"events": info["events"], "max_rel_vs_a": rel_b,
                                  "bit_equal": rel_b == 0.0}
        # (c) host mode, a persistent torch failure from chunk 1
        host = campaign(sub, hcfg, tmp, "host", ckpt_period=0.0, async_snapshots=False)
        res = campaign(sub, hcfg, tmp, "degrade", ckpt_period=0.0, async_snapshots=False,
                       retry=nosleep, chaos=ChaosInjector(torch_fail_at=1))
        ks = kinds(res)
        check(res.meta["campaign"]["engine_degraded"] and res.engine == "batch"
              and ks.count("transient") >= 2, f"campaign chaos degrade: {ks}")
        rel_c = stats_agree(res, host, "campaign chaos degraded vs host", 1e-12)
        cases["c_degraded"] = {"events": ks, "max_rel_vs_host": rel_c}
    emit("campaign_chaos", seconds=time.monotonic() - t0, cells=len(sub.cells),
         lanes=sub.n_lanes, chunk_lanes=CHAOS_CHUNK, cases=cases,
         compared="(a) kills at chunks 1 and 3 resumed bit-equal to the uninterrupted "
                  "device-mode campaign; (b) two shards on the card, one lost: integers "
                  "exact, moments rtol 1e-12 against (a)'s base; (c) host mode degraded "
                  "to the NumPy engine after chunk 0: integers exact, moments rtol 1e-12 "
                  "against the undisturbed host-mode campaign")

    # ---- 37. real faults in subprocesses ------------------------------- #
    t0 = time.monotonic()
    faults = {}
    with tempfile.TemporaryDirectory() as tmp:
        for kind in ("oom", "assert"):
            out = os.path.join(tmp, f"{kind}.json")
            tc = time.monotonic()
            p = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                                "--campaign-fault", kind, out],
                               capture_output=True, text=True, timeout=600)
            check(p.returncode == 0,
                  f"campaign fault {kind}: rc {p.returncode}: {p.stderr[-3000:]}")
            with open(out) as f:
                rec = json.load(f)
            rec["seconds"] = time.monotonic() - tc
            faults[kind] = rec
    oom = faults.pop("oom")
    ks = [e["kind"] for e in oom["campaign"]["events"]]
    check(ks == ["oom", "chunk_halved"] and not oom["campaign"]["engine_degraded"]
          and oom["campaign"]["chunk_lanes_final"] == oom["lanes"] // 2,
          f"real OOM: events {ks}, final chunk {oom['campaign']['chunk_lanes_final']}")
    check(any("OutOfMemoryError" in e.get("error", "") for e in oom["campaign"]["events"]),
          "real OOM: no torch.OutOfMemoryError among the events")
    sticky = faults.pop("assert")
    ks = [e["kind"] for e in sticky["campaign"]["events"]]
    check(ks == ["device_loss"] * 4 + ["engine_degraded"] and sticky["engine"] == "batch",
          f"device-side assert: events {ks}")
    emit("campaign_real_faults", seconds=time.monotonic() - t0,
         oom=oom, device_assert=sticky,
         compared="(d) validation preset, host mode, under set_per_process_memory_fraction "
                  "at the uncapped peak of live bytes less an eighth of the chunk's slab "
                  "bytes: a real torch.OutOfMemoryError, the chunk halved once, integers "
                  "exact and moments "
                  "rtol 1e-9 against the uncapped run; (e) a device-side assert at chunk "
                  "2 of the host-mode sub-grid: device_loss up to the retry budget, the "
                  "NumPy engine to the end, exit 0, integers exact and moments rtol 1e-12 "
                  "against an undisturbed host-mode campaign in the same process; each "
                  "compared in its subprocess")


# --------------------------------------------------------------------------- #
# Training under the paper's policy
# --------------------------------------------------------------------------- #
#: phase 38: SmolLM-135M at full width, 2 layers, f32, on a (batch, tokens)
#: batch; the card against the CPU: the loss (rel), each gradient leaf and
#: one AdamW update's params and moments (max abs diff over the leaf's
#: max |x|)
TRAIN_CHECK_SEED = 0
TRAIN_CHECK_BATCH = (2, 128)
TRAIN_CHECK_TOL = {"loss": 1e-5, "grad": 1e-4, "adamw": 1e-6}
#: phase 39: repro_torch.launch.train at full width, TRAIN_LAYERS of its 30
#: layers (bf16 compute, 8 x 1024 tokens, seed 0; cut from 30 layers to keep the
#: script inside its time limit); the faulted run under the
#: paper-accurate predictor, its faults from the seeded trace of this MTBF,
#: on the executor's simulated clock at TRAIN_SIM_STEP_S a step (the step
#: measured on the H100), so that the same steps fault on every host: 3
#: saves, a memory restore of step 22 and a disk restore of step 55 (the
#: schedule tests/test_torch_executor.py replays on the CPU)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEED = 60, 8, 1024, 0
TRAIN_LAYERS = 15
TRAIN_MTBF, TRAIN_SIM_STEP_S = 12.0, 0.31
TRAIN_LR = 3e-4
#: every second fault loses the buddy's replica too, so the disk tier
#: (int8, through dequantize_blocks) serves it
TRAIN_CORRELATED_EVERY = 2
#: the faulted run's last loss against the fault-free run's (relative),
#: after a restore through the int8 disk tier: each parameter and moment
#: comes back within half a code step of its block (1/254 of the block's
#: absmax).  Steps whose last run followed only exact memory restores must
#: be bit-equal (the phase runs under torch.use_deterministic_algorithms)
TRAIN_LOSS_RTOL = 1e-2
#: phase 40: the CLI on the card, reduced config (15 steps, to keep the
#: script inside its time limit)
TRAIN_CLI_ARGS = ("--steps", "15", "--inject-faults", "--predictor", "paper-accurate",
                  "--fault-mtbf", "0.3", "--memory-tier", "--correlated-every", "2",
                  "--codec", "int8")


def loss_and_grads(model, params, batch):
    """``(loss, {key: grad})`` of ``model.loss_fn`` by ``torch.autograd``."""
    import torch
    from repro_torch.checkpoint.store import flatten_with_keys, map_with_keys

    live = map_with_keys(lambda _, p: p.detach().requires_grad_(True), params)
    loss, _ = model.loss_fn(live, batch)
    flat = flatten_with_keys(live)
    return loss.detach(), dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))


def leaf_rel(got: dict, want: dict) -> float:
    """Largest ``max|got - want| / max|want|`` over the leaves (card vs
    CPU); integer leaves must be equal."""
    import torch

    worst = 0.0
    for k, w in want.items():
        g = got[k].detach().cpu()
        if w.is_floating_point():
            worst = max(worst, float((g - w).abs().max()) / (float(w.abs().max()) or 1.0))
        else:
            check(torch.equal(g, w), f"{k}: differs")
    return worst


def train_step_split(cfg, dev, counters=None, phase: str = "train_split") -> dict:
    """Where a training step's time goes: forward, backward and the AdamW
    update of the train path's step (full size, bf16 compute), each timed
    with CUDA events (median of 3 after a warm-up step), and the device
    kernels of one step by total time in a ``torch.profiler`` trace.
    ``counters`` (name -> a function reading a launch count) are read
    around the warm-up step's forward and backward.  Emits ``phase`` and
    returns its record."""
    import statistics

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.checkpoint.store import flatten_with_keys, map_with_keys
    from repro_torch.launch.steps import build_model
    from repro_torch.launch.train import make_train_state
    from repro_torch.models import RuntimeFlags
    from repro_torch.optim import adamw_update, cosine_schedule

    t0 = time.monotonic()
    model = build_model(cfg, RuntimeFlags(dense_attn_max=512))
    st = make_train_state(cfg, model, TRAIN_SEED, dev)
    toks = torch.from_numpy(np.random.default_rng(TRAIN_SEED).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)).to(dev)

    counters = counters or {}
    per_step = {}

    def read():
        return {k: f() for k, f in counters.items()}

    def step(times=None):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        c0 = read()
        ev[0].record()
        live = map_with_keys(lambda _, p: p.detach().requires_grad_(True), st["params"])
        loss, _ = model.loss_fn(live, {"tokens": toks})
        ev[1].record()
        c1 = read()
        flat = flatten_with_keys(live)
        grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
        ev[2].record()
        c2 = read()
        if times is None:
            per_step.update({k: {"forward": c1[k] - c0[k], "backward": c2[k] - c1[k]}
                             for k in counters})
        lr = cosine_schedule(st["opt"].step, TRAIN_LR, warmup=100, total=TRAIN_STEPS)
        out = adamw_update(map_with_keys(lambda k, _: grads[k], st["params"]), st["opt"],
                           st["params"], lr)
        ev[3].record()
        torch.cuda.synchronize()
        if times is not None:
            for i, name in enumerate(("forward", "backward", "adamw")):
                times[name].append(ev[i].elapsed_time(ev[i + 1]))
        return out

    step()
    times = {"forward": [], "backward": [], "adamw": []}
    for _ in range(3):
        step(times)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
    rows = []
    for e in prof.key_averages():
        dt = getattr(e, "device_time_total", None)
        if dt is None:
            dt = getattr(e, "cuda_time_total", 0.0)
        if dt:
            rows.append((dt, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    split = {k: statistics.median(v) for k, v in times.items()}
    rec = {"seconds": time.monotonic() - t0, "arch": cfg.name, "ms": split,
           "step_ms": sum(split.values()), "profiled_device_ms": busy,
           "device_kernels": sum(r[2] for r in rows), "launches_per_step": per_step,
           "top_kernels": [{"name": k[:80], "ms": dt / 1e3, "calls": n}
                           for dt, k, n in rows[:12]]}
    emit(phase, **rec,
         note="CUDA events around forward (loss_fn), backward (autograd.grad) and "
              "adamw_update of one step on a fixed batch; profiled_device_ms: the device "
              "kernels' total time in one profiled step")
    del st
    return rec


def train_phases(dev, kernels: list) -> None:
    """Phases 38-40: the training step on the card against the CPU, the
    training path (``repro_torch.launch.train`` at full size under the
    executor, fault-free and faulted, through the int8 store and the buddy
    memory tier) and the train CLI on the card.  Adds the training path's
    codec launches to the codec entries of ``kernels``."""
    import dataclasses
    import statistics

    import numpy as np
    import torch
    from repro_torch.checkpoint.store import flatten_with_keys, map_with_keys
    from repro_torch.configs import get
    from repro_torch.core.waste import waste_exact
    from repro_torch.kernels import ckpt_codec as CK
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.train import train
    from repro_torch.models import LanguageModel, RuntimeFlags
    from repro_torch.optim import adamw_init, adamw_update

    cfg = get("smollm-135m")

    # ---- 38. the training step, card against CPU ----------------------- #
    t0 = time.monotonic()
    cpu_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    small = dataclasses.replace(cfg, num_layers=2)
    B, S = TRAIN_CHECK_BATCH
    toks = torch.from_numpy(np.random.default_rng(TRAIN_CHECK_SEED).integers(
        0, small.vocab_size, (B, S)).astype(np.int32))
    p_cpu = LanguageModel(small).init(torch.Generator().manual_seed(TRAIN_CHECK_SEED))
    p_gpu = map_with_keys(lambda _, x: x.to(dev), p_cpu)
    diffs, losses = {}, {}
    for what, dmax in (("dense", 512), ("chunked", S // 2)):
        flags = RuntimeFlags(compute_dtype=torch.float32, dense_attn_max=dmax)
        m_cpu, m_gpu = LanguageModel(small, flags), LanguageModel(small, flags)
        fl0 = FA.flash_attention_bhsd.launches
        l_gpu, g_gpu = loss_and_grads(m_gpu, p_gpu, {"tokens": toks.to(dev)})
        torch.cuda.synchronize()
        check(FA.flash_attention_bhsd.launches == fl0,
              f"train_check/{what}: the flash kernel ran in a training step")
        l_cpu, g_cpu = loss_and_grads(m_cpu, p_cpu, {"tokens": toks})
        d = {"loss": abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu)),
             "grad": leaf_rel(g_gpu, g_cpu)}
        if what == "dense":  # one update on the CPU's gradients, both sides
            lr = torch.tensor(1e-3)
            n_cpu, s_cpu, _ = adamw_update(map_with_keys(lambda k, _: g_cpu[k], p_cpu),
                                           adamw_init(p_cpu), p_cpu, lr)
            n_gpu, s_gpu, _ = adamw_update(map_with_keys(lambda k, _: g_cpu[k].to(dev), p_cpu),
                                           adamw_init(p_gpu), p_gpu, lr.to(dev))
            d["adamw"] = max(leaf_rel(flatten_with_keys(n_gpu), flatten_with_keys(n_cpu)),
                             leaf_rel(flatten_with_keys(s_gpu), flatten_with_keys(s_cpu)))
        for k, v in d.items():
            check(v <= TRAIN_CHECK_TOL[k],
                  f"train_check/{what}: {k} off by {v} > {TRAIN_CHECK_TOL[k]}")
        diffs[what], losses[what] = d, float(l_gpu)
    torch.set_num_threads(cpu_threads)
    # a backward through the flash kernel raises on the card
    m_pal = LanguageModel(small, RuntimeFlags(compute_dtype=torch.float32, attn_impl="pallas"))
    live = map_with_keys(lambda _, p: p.detach().requires_grad_(True), p_gpu)
    fl0 = FA.flash_attention_bhsd.launches
    loss, _ = m_pal.loss_fn(live, {"tokens": toks.to(dev)})
    pallas_launches = FA.flash_attention_bhsd.launches - fl0
    check(pallas_launches == small.num_layers,
          f"train_check: attn_impl='pallas' launched the flash kernel {pallas_launches} times")
    raised = None
    try:
        loss.backward()
    except NotImplementedError as e:
        raised = str(e)
    check(raised is not None, "train_check: a backward through the flash kernel did not raise")
    del live, loss, p_gpu, m_pal
    emit("train_check", seconds=time.monotonic() - t0, layers=small.num_layers,
         batch=[B, S], compute="float32", loss=losses, rel_diff=diffs, tol=TRAIN_CHECK_TOL,
         flash_launches_in_step=0, pallas_forward_launches=pallas_launches,
         pallas_backward_raised=raised[:100],
         compared="card vs CPU (one thread): loss rel; every gradient leaf and one "
                  "adamw_update's params and moments, max abs diff over the leaf's "
                  "max |x|; dense (S <= dense_attn_max) and chunked attention")

    # ---- 39. the training path, fault-free and faulted ------------------ #
    t0 = time.monotonic()
    path_cfg = dataclasses.replace(cfg, num_layers=TRAIN_LAYERS)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    kw = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
              seed=TRAIN_SEED, codec="int8", memory_tier=True,
              correlated_every=TRAIN_CORRELATED_EVERY, fault_mtbf=TRAIN_MTBF,
              sim_step_s=TRAIN_SIM_STEP_S, predictor="paper-accurate", strategy="auto",
              flags=RuntimeFlags(dense_attn_max=512), device=dev, log=lambda s: None)
    runs, codec = {}, {}
    try:
        for name, inject in (("fault_free", False), ("faulted", True)):
            CK.quantize_blocks.launches = CK.dequantize_blocks.launches = 0
            FA.flash_attention_bhsd.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            runs[name] = train(path_cfg, inject_faults=inject, **kw)
            torch.cuda.synchronize()
            runs[name]["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            codec[name] = {"quantize_blocks": CK.quantize_blocks.launches,
                           "dequantize_blocks": CK.dequantize_blocks.launches}
            check(FA.flash_attention_bhsd.launches == 0,
                  f"train_path/{name}: the flash kernel ran in training")
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    clean, hit = runs["fault_free"], runs["faulted"]
    rep = hit["report"]
    last = TRAIN_STEPS - 1
    tokens = TRAIN_BATCH * TRAIN_SEQ
    disk = [e for e in hit["restores"] if e["tier"] == "disk"]
    n_saves = len(hit["saves"])
    q, dq = codec["faulted"]["quantize_blocks"], codec["faulted"]["dequantize_blocks"]
    # bit-equal losses up to the first disk restore (memory restores are
    # exact copies), the last within TRAIN_LOSS_RTOL
    first_disk = min((e["step"] for e in disk), default=TRAIN_STEPS)
    unequal = [k for k in range(first_disk) if hit["losses"].get(k) != clean["losses"].get(k)]
    rel_last = abs(hit["losses"][last] - clean["losses"][last]) / abs(clean["losses"][last])
    summary = {}
    for name, r in runs.items():
        rp = r["report"]
        step_ms = statistics.median(s for _, s in r["step_s"]) * 1e3
        r_meas = rp.ledger.recovery / rp.n_restores if rp.n_restores else 0.0
        rec, prec = (0.85, 0.82) if name == "faulted" else (0.0, 1.0)
        summary[name] = {
            "wall_s": r["wall_s"], "clock_s": r["clock_s"], "step_ms_median": step_ms,
            "step_ms_min": min(s for _, s in r["step_s"]) * 1e3,
            "steps_run": len(r["step_s"]), "tokens_per_s_step": tokens / step_ms * 1e3,
            "tokens_per_s_wall": TRAIN_STEPS * tokens / r["wall_s"],
            "first_loss": r["losses"][0], "last_loss": r["losses"][last],
            "saves": r["saves"], "c_estimate": rp.c_estimate, "period_T": rp.period_T,
            "q": rp.q, "counts": {"periodic": rp.n_periodic, "proactive": rp.n_proactive,
                                  "faults": rp.n_faults, "restores": rp.n_restores,
                                  "migrations": rp.n_migrations},
            "restores": r["restores"], "ledger": rp.ledger.as_dict(),
            "analytic_waste": rp.analytic_waste, "measured_R": r_meas,
            "waste_exact_own": float(waste_exact(rp.period_T, rp.q, rp.c_estimate, 0.2,
                                                 r_meas, TRAIN_MTBF, rec, prec)),
            "codec_launches": codec[name], "peak_bytes": r["peak_bytes"],
        }
    emit("train_path", seconds=time.monotonic() - t0, layers=path_cfg.num_layers,
         of_layers=cfg.num_layers,
         batch=[TRAIN_BATCH, TRAIN_SEQ], compute="bfloat16", steps=TRAIN_STEPS,
         lr=TRAIN_LR, mtbf=TRAIN_MTBF, sim_step_s=TRAIN_SIM_STEP_S, deterministic=True,
         runs=summary, fault_times=[t for t in hit["fault_times"] if t <= hit["clock_s"]],
         quantize_per_save=q / max(n_saves, 1),
         dequantize_per_disk_restore=dq / max(len(disk), 1),
         bit_equal_steps=first_disk - len(unequal), first_disk_restore_step=first_disk,
         last_loss_rel_diff=rel_last, tol=TRAIN_LOSS_RTOL,
         compared="losses of the steps before the first disk restore bit-equal to the "
                  "fault-free run's (torch.use_deterministic_algorithms); the last "
                  "step's within the stated rel tolerance (int8 restore)")
    for name, r in runs.items():
        ls = r["losses"]
        check(sorted(ls) == list(range(TRAIN_STEPS)), f"train_path/{name}: steps {sorted(ls)}")
        check(all(math.isfinite(v) for v in ls.values()), f"train_path/{name}: non-finite loss")
        check(ls[last] < ls[0], f"train_path/{name}: the loss did not fall "
              f"({ls[0]} -> {ls[last]})")
    check(rep.n_faults >= 2 and rep.n_restores == rep.n_faults,
          f"train_path: {rep.n_faults} faults, {rep.n_restores} restores (2 or more wanted)")
    check(disk, f"train_path: no restore came from the disk tier: {hit['restores']}")
    check(q > 0 and q % n_saves == 0, f"train_path: {q} quantize launches over {n_saves} saves")
    check(dq > 0 and dq % len(disk) == 0,
          f"train_path: {dq} dequantize launches over {len(disk)} disk restores")
    check(not unequal, f"train_path: steps {unequal} differ from the fault-free run before "
          "any disk restore")
    check(rel_last <= TRAIN_LOSS_RTOL,
          f"train_path: last loss {hit['losses'][last]} vs the fault-free run's "
          f"{clean['losses'][last]} (rel {rel_last} > {TRAIN_LOSS_RTOL})")
    for k in kernels:
        if k["name"] in ("quantize_blocks", "dequantize_blocks"):
            k["train_path_launches"] = codec["faulted"][k["name"]]
    del runs, clean, hit
    train_step_split(path_cfg, dev)

    # ---- 40. the train CLI on the card ---------------------------------- #
    t0 = time.monotonic()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CLI_ARGS],
                       env=env, capture_output=True, text=True, timeout=600)
    check(p.returncode == 0, f"train CLI: rc {p.returncode}: {p.stderr[-2000:]}")
    out = p.stdout
    check("== run report ==" in out and "waste=" in out, f"train CLI output: {out[-2000:]}")
    check(" on cuda" in out, f"train CLI did not run on the card: {out[-500:]}")
    waste = float(out.split("waste=")[1].split()[0])
    check(0.0 <= waste < 1.0, f"train CLI: waste {waste}")
    emit("train_cli", seconds=time.monotonic() - t0, args=list(TRAIN_CLI_ARGS), waste=waste,
         tail=out.strip().splitlines()[-5:])


# --------------------------------------------------------------------------- #
# The dense and MoE families
# --------------------------------------------------------------------------- #
#: the families served on the card in phases 43-44, phase 41's attention
#: shapes taken from their configs
FAMILIES = ("qwen3-moe-30b-a3b", "qwen2-0.5b", "granite-8b", "qwen2-72b", "arctic-480b")
#: Qwen3-30B-A3B's serving depth: 4 of its 48 layers through serve() (cut to keep
#: the script inside its time limit; all 48, 61 GB of bf16 weights, fit the card, and were served here until the
#: recurrent families' training phases 49-52 needed the script's time; a
#: prefill and the decode step's split ran at all 48 before); the
#: depth cuts of the two configs that do not fit and of granite-8b (for
#: the same reason), and Arctic's shorter generation
QWEN3_LAYERS = 4
#: phase 42's depth, and phase 43's prefill and decode
#: split (cut from all 48 layers to keep the script inside its time limit)
QWEN3_CPU_LAYERS, QWEN3_SPLIT_LAYERS = 1, 12
DEPTH_CUTS = {"qwen2-72b": 4, "arctic-480b": 2, "granite-8b": 6, "qwen2-0.5b": 12}
ARCTIC_GEN = 32
#: Qwen3 at full width, QWEN3_CPU_LAYERS, on the card against the port on the CPU.
#: f32: the routing must be equal (expert ids and keep mask of every MoE
#: call); the logits tolerances are those of tests/test_torch_families.py
#: (measured there against the reference: decode steps move where a K/V
#: entry within rounding noise of a bf16 boundary rounds the other way),
#: the prefill's widened 10x for two layers of 128 experts over the full
#: vocabulary.  Measured on the H100: 6.2e-6, 4.7e-5 and 4.2e-4.  bf16: at
#: most 3% of the (token, choice) pairs may route elsewhere (near ties of
#: two router probabilities; measured 12 of 2,176), and the logits, with
#: the card routed as the CPU, within 3e-2 of max|logit| (measured 9.9e-3).
QWEN3_CARD_CPU_TOL = {"prefill": 1e-4, "decode_same_cache": 2e-3, "decode_own_cache": 5e-3}
QWEN3_BF16_TOL, QWEN3_BF16_MAX_DIFFERING = 3e-2, 0.03

# --------------------------------------------------------------------------- #
# The Mamba hybrid and the frontend families
# --------------------------------------------------------------------------- #
JAMBA = "jamba-1.5-large-398b"
FRONTEND_FAMILIES = ("llava-next-mistral-7b", "musicgen-large")
#: Jamba on one card: 1 of its 9 repeats of the 8-layer pattern (7 Mamba, 1
#: attention) and 8 of its 16 experts, top-2 kept: 25.9 B parameters, 51.8
#: GB of bf16 weights (one repeat with every expert is 90.5 GB)
JAMBA_LAYERS, JAMBA_EXPERTS = 8, 8
#: generated tokens of the frontend families' serving runs, and their
#: depth (half their layers, to keep the script inside its time limit)
FRONTEND_GEN = 32
FRONTEND_LAYERS = {"llava-next-mistral-7b": 16, "musicgen-large": 24}
SCAN_SOURCE = "src/repro_torch/kernels/csrc/mamba_scan.cu"
#: the lax.scan the kernel takes the place of (no TPU kernel: the
#: reference has no Pallas kernel for it)
SCAN_REPLACES = "src/repro/models/ssm.py:98"
#: the scan kernel's y against its plain version's, as a fraction of
#: max|y| (its torch emulation on the CPU: 2e-7); the final state must be
#: bit-equal
SCAN_Y_TOL = 1e-5
#: f32 operations a state entry and token: dt A, its exp, da h, u B, their
#: sum, h C, the y sum (and u = dt x once a channel and token); f32
#: instructions an entry issues at least (the exp's range reduction and ex2
#: among them)
SCAN_OPS_PER_ENTRY, SCAN_ISSUE_PER_ENTRY = 7, 8
#: one Mamba block at full width, f32, and Jamba at a width cut (its 8
#: pattern layers, 16 experts, d_model 1024, hd 128 at group 8), card
#: against the port on the CPU: the block's output and state within 1e-5
#: of their max (f32 products summed in other orders; the CPU holds the
#: reference's to 1e-6, tests/test_torch_mamba.py), decode from each side's
#: own bf16 conv window within 1e-3 of max (a window entry within noise of
#: a bf16 boundary rounds the other way); Jamba's logits within
#: QWEN3_CARD_CPU_TOL, its prefill's widened 3x as in
#: tests/test_torch_families.py.  Routing must be equal in f32.
MAMBA_CARD_CPU_TOL = {"prefill": 1e-5, "state": 1e-5, "decode_own_cache": 1e-3}
JAMBA_CARD_CPU_TOL = {"prefill": 3e-4, "decode_same_cache": 2e-3, "decode_own_cache": 5e-3}


class RoutingTap:
    """Inside ``with``: records every MoE call's routing (expert ids and
    keep mask, on the CPU) and, when ``follow`` holds another run's expert
    ids in call order, makes the port's top-k take them, counting the
    (token, choice) pairs where its own choice is not among them."""

    def __init__(self, follow=None):
        from repro_torch.models import moe

        self.moe, self.route, self.top_k = moe, moe.route, moe._top_k
        self.calls, self.follow = [], None if follow is None else list(follow)
        self.pairs = self.differing = 0

    def __enter__(self):
        self.moe.route, self.moe._top_k = self._route, self._top_k
        return self

    def __exit__(self, *exc):
        self.moe.route, self.moe._top_k = self.route, self.top_k

    def _route(self, *args, **kw):
        r = self.route(*args, **kw)
        self.calls.append((r.expert_ids.cpu(), r.keep.cpu()))
        return r

    def _top_k(self, probs, k):
        vals, ids = self.top_k(probs, k)
        if self.follow is None:
            return vals, ids
        want = self.follow.pop(0).to(ids.device)
        self.pairs += ids.numel()
        self.differing += int((ids[..., :, None] != want[..., None, :]).all(-1).sum())
        return probs.gather(-1, want), want


def routing_mismatches(a: list, b: list) -> int:
    """MoE calls of two runs whose expert ids or keep mask differ."""
    import torch

    check(len(a) == len(b), f"{len(a)} MoE calls against {len(b)}")
    return sum(not (torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])) for x, y in zip(a, b))


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def serve_family(cfg, gen: int, faulted: bool, dev) -> dict:
    """``serve()`` on ``cfg`` (8 x 1024 prompt tokens after the config's
    frontend prefix, ``gen`` generated, a snapshot every 16), fault-free
    and, with ``faulted``, again under wall-clock faults whose tokens must
    equal the fault-free ones.  Checks one flash launch an attention layer
    in the prefill (all on the tensor-core kernel), one decode call an
    attention layer a decode step, and one ``selective_scan`` launch a
    Mamba layer in the prefill and in each decode step; returns the
    record."""
    import torch
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import mamba as MB
    from repro_torch.launch.serve import fault_trace, serve

    L = cfg.n_repeats * sum(s.mixer == "attn" for s in cfg.pattern)
    M = cfg.n_repeats * sum(s.mixer == "mamba" for s in cfg.pattern)
    kw = dict(requests=REQUESTS, prompt_len=PROMPT_LEN, gen=gen, snapshot_every=SNAPSHOT_EVERY,
              seed=SERVE_SEED, device=dev)

    def run(times):
        FA.flash_attention_bhsd.launches = 0
        FA.flash_attention_bhsd.tc_launches = 0
        DA.decode_attention_bhd.launches = 0
        MB.selective_scan.launches = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        res = serve(cfg, fault_times=times, **kw)
        res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        res["launches"] = {"flash_attention_bhsd": FA.flash_attention_bhsd.launches,
                           "decode_attention_bhd": DA.decode_attention_bhd.launches,
                           "selective_scan": MB.selective_scan.launches}
        check(FA.flash_attention_bhsd.tc_launches == L,
              f"{cfg.name}: {FA.flash_attention_bhsd.tc_launches} of the prefill's {L} flash "
              "launches took the tensor-core kernel")
        check(res["launches"]["flash_attention_bhsd"] == L,
              f"{cfg.name}: flash launched {res['launches']['flash_attention_bhsd']} times in "
              f"one prefill of {L} attention layers")
        check(res["launches"]["decode_attention_bhd"] == L * res["decode_steps"],
              f"{cfg.name}: decode launched {res['launches']['decode_attention_bhd']} times in "
              f"{res['decode_steps']} steps of {L} attention layers")
        check(res["launches"]["selective_scan"] == M * (1 + res["decode_steps"]),
              f"{cfg.name}: selective_scan launched {res['launches']['selective_scan']} times in "
              f"a prefill and {res['decode_steps']} steps of {M} Mamba layers")
        return res

    clean = run(())
    toks = clean["tokens"]
    check(tuple(toks.shape) == (REQUESTS, gen), f"{cfg.name}: tokens {tuple(toks.shape)}")
    check(clean["decode_steps"] == gen - 1, f"{cfg.name}: {clean['decode_steps']} decode steps")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), f"{cfg.name}: token out of range")
    out = {
        "model": cfg.name, "layers": cfg.num_layers, "attention_layers": L, "mamba_layers": M,
        "of_layers": None, "d_model": cfg.d_model, "frontend_prefix": cfg.frontend_prefix,
        "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim],
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "weight_bytes": 2 * cfg.param_count(), "requests": REQUESTS, "prompt_len": PROMPT_LEN,
        "gen": gen, "prefill_s": clean["prefill_s"], "decode_s": clean["decode_s"],
        "decode_ms_per_token": clean["decode_s"] * 1e3 / clean["decode_steps"],
        "tokens_per_s": REQUESTS * gen / clean["wall_s"], "wall_s": clean["wall_s"],
        "peak_bytes": clean["peak_bytes"], "launches": clean["launches"],
    }
    if faulted:
        mtbf = clean["decode_s"] / 4
        times = fault_trace(SERVE_SEED, mtbf)[:MAX_FAULTS]
        f = run(times)
        check(f["faults"] >= 1, f"{cfg.name}: no fault landed in the faulted run")
        check(torch.equal(f["tokens"], toks),
              f"{cfg.name}: the faulted run's tokens differ from the fault-free run's in "
              f"{int((f['tokens'] != toks).sum())} places")
        check(f["decode_steps"] == gen - 1 + f["redecoded"], f"{cfg.name}: replays miscounted")
        out["faulted"] = {"mtbf_s": mtbf, "fault_times_s": times, "faults": f["faults"],
                          "redecoded": f["redecoded"], "decode_steps": f["decode_steps"],
                          "wall_s": f["wall_s"], "peak_bytes": f["peak_bytes"],
                          "launches": f["launches"], "tokens_equal_fault_free": True}
    return out


def decode_step_split(model, params, cache, tok) -> dict:
    """Where one decode step's time goes: the step issued eagerly (CUDA
    events, the host's rate), its host syncs (``set_sync_debug_mode``
    warnings), the step replayed as a CUDA graph (device time; only
    without syncs) and its device kernels by name in a profiler trace.
    Each call writes the cache in place one row further."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    def step():
        return model.decode_step(params, cache, tok)

    step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    out = {"eager_ms": eager_ms(step, 5), "host_syncs": syncs, "graph_ms": None}
    if syncs == 0:
        out["graph_ms"] = device_ms([step], samples=5)[0]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    rows = [(e.key, getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)) / 1e3,
             e.count) for e in prof.key_averages()]
    rows = [r for r in rows if r[1] > 0]
    rows.sort(key=lambda r: -r[1])
    out["device_kernels"] = sum(r[2] for r in rows)
    out["device_busy_ms"] = sum(r[1] for r in rows)
    out["top_kernels"] = [{"name": n[:90], "ms": t, "count": c} for n, t, c in rows[:12]]
    return out


def attn_shape_rows(name: str, B: int, S: int, H: int, KV: int, hd: int, max_seq: int,
                    pos: int, flash_seed: int, decode_seed: int, dev) -> dict:
    """Both attention kernels at one model's serving shapes, bf16.  Flash
    (causal prefill of ``B x S`` over ``H / KV`` heads of ``hd``): checked
    against its plain version (the tensor-core kernel required), then timed
    over input sets that together read three times the L2, beside its plain
    version and SDPA.  Decode over a ``(B, max_seq, KV, hd)`` cache: checked
    at pos -1, 0, a split's edges, ``pos`` and the last row, then timed at
    ``pos`` over caches three times the L2.  Returns each kernel's row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops

    rows = {}
    bf = torch.bfloat16
    # flash, causal prefill: the path's shape, checked, then timed over
    # input sets that together read three times the L2
    set_bytes = 2 * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    sets = [flash_inputs(B, S, S, H, KV, hd, bf, flash_seed + i, dev)
            for i in range(math.ceil(3 * L2_BYTES / set_bytes))]
    tc0 = FA.flash_attention_bhsd.tc_launches
    got = ops.flash_attention(*sets[0], True)
    torch.cuda.synchronize()
    variant = "tc" if FA.flash_attention_bhsd.tc_launches > tc0 else "simt"
    check(variant == "tc", f"flash_attention_bhsd/{name}: took the {variant} kernel")
    e = attn_close(got, FA.attention_ref(*sets[0], True), f"flash_attention_bhsd/{name}")
    ms, out = device_ms([lambda x=x: ops.flash_attention(*x, True) for x in sets])
    pms, pout = device_ms([lambda x=x: FA.attention_ref(*x, True) for x in sets])
    lms, lout = device_ms([lambda x=x: F.scaled_dot_product_attention(
        x[0].transpose(1, 2), x[1].transpose(1, 2), x[2].transpose(1, 2),
        is_causal=True, enable_gqa=True) for x in sets])
    attn_close(out, pout, f"flash_attention_bhsd/{name} (timed) against its plain version")
    attn_close(out, lout.transpose(1, 2), f"flash_attention_bhsd/{name} (timed) against sdpa")
    ops_f = 4 * hd * B * H * S * (S + 1) // 2
    t_ops, t_bytes = ops_f / PEAK_BF16_S * 1e3, set_bytes / PEAK_BYTES_S * 1e3
    rows["flash_attention_bhsd"] = {
        "model": name, "shape": f"q ({B}, {S}, {H}, {hd}), k/v ({B}, {S}, {KV}, {hd}) bf16, "
        f"causal, group {H // KV}", "variant": variant, "max_abs_err": e, "ms": ms,
        "plain_ms": pms, "library_ms": lms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes", "ops": ops_f,
        "bytes": set_bytes, "input_sets": len(sets)}
    del sets, got, out, pout, lout
    # decode over the bf16 cache: every split edge, then timed at the
    # middle position of the path's decode over caches three times the L2
    g = torch.Generator(device=dev)
    g.manual_seed(decode_seed)
    cache_bytes = 2 * B * max_seq * KV * hd * 2
    layers = [tuple(torch.randn(shape, generator=g, device=dev).to(bf)
                    for shape in ((B, 1, H, hd), (B, max_seq, KV, hd), (B, max_seq, KV, hd)))
              for _ in range(math.ceil(3 * L2_BYTES / cache_bytes))]
    qd, kc, vc = layers[0]
    R = DA.SPLIT_ROWS
    e = 0.0
    for p_ in (-1, 0, R - 1, R, pos, max_seq - 1):
        p = torch.tensor(p_, dtype=torch.int32, device=dev)
        got = ops.decode_attention(qd, kc, vc, p)
        want = DA.attention_ref(qd[:, 0], kc, vc, p).unsqueeze(1)
        torch.cuda.synchronize()
        e = max(e, attn_close(got, want, f"decode_attention_bhd/{name}/pos{p_}"))
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    ms, out = device_ms([lambda x=x: ops.decode_attention(*x, p) for x in layers])
    pms, pout = device_ms([lambda x=x: DA.attention_ref(x[0][:, 0], x[1], x[2], p)
                           for x in layers])
    lms, lout = device_ms([lambda x=x: F.scaled_dot_product_attention(
        x[0].transpose(1, 2), x[1][:, :pos + 1].transpose(1, 2),
        x[2][:, :pos + 1].transpose(1, 2), enable_gqa=True) for x in layers])
    attn_close(out, pout.unsqueeze(1), f"decode_attention_bhd/{name} (timed) against its "
               "plain version")
    attn_close(out, lout.transpose(1, 2), f"decode_attention_bhd/{name} (timed) against sdpa")
    d_bytes = 2 * B * (pos + 1) * KV * hd * 2 + 2 * B * H * hd * 2 + 4
    d_ops = 4 * hd * B * H * (pos + 1)
    t_ops, t_bytes = d_ops / PEAK_BF16_S * 1e3, d_bytes / PEAK_BYTES_S * 1e3
    rows["decode_attention_bhd"] = {
        "model": name, "shape": f"q ({B}, 1, {H}, {hd}), cache ({B}, {max_seq}, {KV}, {hd}) "
        f"bf16, pos {pos}, group {H // KV}", "max_abs_err": e, "ms": ms, "plain_ms": pms,
        "library_ms": lms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops > t_bytes else "bytes", "ops": d_ops,
        "bytes": d_bytes, "caches": len(layers), "splits": DA.split_count(max_seq)}
    del layers, out, pout, lout
    return rows


def family_phases(dev, kernels: list) -> None:
    """Phases 41-44: the attention kernels at the dense and MoE families'
    shapes, Qwen3-30B-A3B card against CPU, Qwen3-30B-A3B served at full
    size, and the other four families served (two of them at a depth
    cut).  Adds each shape's times and each path's launches to the
    attention entries of ``kernels``."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.checkpoint.store import map_with_keys
    from repro_torch.configs import get
    from repro_torch.models import LanguageModel, RuntimeFlags

    B, S = REQUESTS, PROMPT_LEN
    max_seq = PROMPT_LEN + GEN + 8
    pos = PROMPT_LEN + GEN // 2 - 1

    # ---- 41. the attention kernels at the families' shapes ------------- #
    t0 = time.monotonic()
    shapes = {"flash_attention_bhsd": [], "decode_attention_bhd": []}
    err = {"flash_attention_bhsd": 0.0, "decode_attention_bhd": 0.0}
    for si, name in enumerate(FAMILIES):
        cfg = get(name)
        rows = attn_shape_rows(name, B, S, cfg.num_heads, cfg.num_kv_heads,
                               cfg.resolved_head_dim, max_seq, pos, 400 + 10 * si, 500 + si, dev)
        for k, row in rows.items():
            shapes[k].append(row)
            err[k] = max(err[k], row["max_abs_err"])
    emit("family_attn_check", seconds=time.monotonic() - t0, shapes=shapes, tol=ATTN_TOL,
         nvidia_smi=smi_line())

    # ---- 42. Qwen3 at full width, 1 layer: card against CPU ------------ #
    t0 = time.monotonic()
    cpu_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    small = dataclasses.replace(get("qwen3-moe-30b-a3b"), num_layers=QWEN3_CPU_LAYERS)
    g = torch.Generator(device=dev)
    g.manual_seed(SERVE_SEED)
    p_gpu = LanguageModel(small).init(g)  # f32 masters, made on the card
    p_cpu = map_with_keys(lambda _, x: x.cpu(), p_gpu)
    toks = torch.from_numpy(np.random.default_rng(SERVE_SEED).integers(
        0, small.vocab_size, (2, 64)).astype(np.int32))
    steps, ms_ = 4, 64 + 16
    res42 = {}
    for cname, cd in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        flags = RuntimeFlags(compute_dtype=cd)
        m_cpu, m_gpu = LanguageModel(small, flags), LanguageModel(small, flags)
        w_cpu, w_gpu = m_cpu.cast_params(p_cpu), m_gpu.cast_params(p_gpu)  # cast once
        f32 = cd == torch.float32
        with RoutingTap() as tc:
            lc, cc = m_cpu.prefill(w_cpu, toks, ms_)
        with RoutingTap(None if f32 else [i for i, _ in tc.calls]) as tg:
            lg, cg = m_gpu.prefill(w_gpu, toks.to(dev), ms_)
        # largest difference, absolute and as a share of the CPU's max|logit|
        d = {"prefill": float((lg.float().cpu() - lc.float()).abs().max())}
        rel = {"prefill": d["prefill"] / float(lc.float().abs().max())}
        mism = routing_mismatches(tc.calls, tg.calls) if f32 else None
        tok = lc[:, -1].argmax(-1).to(torch.int32)[:, None]
        same_tokens = True
        for _ in range(steps):
            n0 = len(tc.calls)
            synced = {"pos": cc["pos"].to(dev, copy=True),
                      "blocks": tuple({k: v.to(dev, copy=True) for k, v in b.items()}
                                      for b in cc["blocks"])}
            with tc:
                lc, cc = m_cpu.decode_step(w_cpu, cc, tok)
            if f32:
                with RoutingTap() as ts:
                    ls, _ = m_gpu.decode_step(w_gpu, synced, tok.to(dev))
                d["decode_same_cache"] = max(d.get("decode_same_cache", 0.0),
                                             float((ls.cpu() - lc).abs().max()))
                mism += routing_mismatches(tc.calls[n0:], ts.calls)
                lg, cg = m_gpu.decode_step(w_gpu, cg, tok.to(dev))
            else:  # the card routed as the CPU
                tg.follow = [i for i, _ in tc.calls[n0:]]
                with tg:
                    lg, cg = m_gpu.decode_step(w_gpu, cg, tok.to(dev))
            del synced
            diff = float((lg.float().cpu() - lc.float()).abs().max())
            d["decode_own_cache"] = max(d.get("decode_own_cache", 0.0), diff)
            rel["decode_own_cache"] = max(rel.get("decode_own_cache", 0.0),
                                          diff / float(lc.float().abs().max()))
            same_tokens &= bool(torch.equal(lg.float().cpu().argmax(-1), lc.float().argmax(-1)))
            tok = lc[:, -1].argmax(-1).to(torch.int32)[:, None]
        if f32:
            check(mism == 0, f"Qwen3 card vs CPU, f32: {mism} MoE calls routed otherwise")
            for k, tol in QWEN3_CARD_CPU_TOL.items():
                check(d[k] <= tol, f"Qwen3 card vs CPU, f32: {k} logits differ by {d[k]} > {tol}")
            res42[cname] = {"max_abs_diff": d, "max_over_max_logit": rel,
                            "tol": QWEN3_CARD_CPU_TOL, "moe_calls": len(tc.calls),
                            "routing_mismatched_calls": mism, "greedy_tokens_equal": same_tokens}
        else:
            check(tg.differing <= QWEN3_BF16_MAX_DIFFERING * tg.pairs,
                  f"Qwen3 card vs CPU, bf16: {tg.differing} of {tg.pairs} pairs routed otherwise")
            worst = max(rel.values())
            check(worst <= QWEN3_BF16_TOL,
                  f"Qwen3 card vs CPU, bf16: logits differ by {worst} of max|logit|")
            # the card against itself: a repeated prefill gives the same bits
            la, ca = m_gpu.prefill(w_gpu, toks.to(dev), ms_)
            lb, cb = m_gpu.prefill(w_gpu, toks.to(dev), ms_)
            bit_equal = bool(torch.equal(la, lb)) and all(
                torch.equal(x[k], y[k]) for x, y in zip(ca["blocks"], cb["blocks"]) for k in x)
            check(bit_equal, "Qwen3 bf16: a repeated prefill on the card changed the bits")
            res42[cname] = {"max_abs_diff": d, "max_over_max_logit": worst, "tol": QWEN3_BF16_TOL,
                            "routed_pairs": tg.pairs, "pairs_routed_otherwise": tg.differing,
                            "max_share_routed_otherwise": QWEN3_BF16_MAX_DIFFERING,
                            "greedy_tokens_equal": same_tokens,
                            "repeated_prefill_bit_equal": bit_equal}
            del la, ca, lb, cb
        del m_cpu, m_gpu, w_cpu, w_gpu, lc, cc, lg, cg
    torch.set_num_threads(cpu_threads)
    del p_gpu, p_cpu
    torch.cuda.empty_cache()
    emit("qwen3_card_vs_cpu", seconds=time.monotonic() - t0, layers=QWEN3_CPU_LAYERS,
         batch=2, prompt=64,
         decode_steps=steps, cpu_threads=1, results=res42)

    # ---- 43. Qwen3-30B-A3B at full size through serve() ---------------- #
    t0 = time.monotonic()
    cfg = dataclasses.replace(get("qwen3-moe-30b-a3b"), param_dtype="bfloat16",
                              num_layers=QWEN3_LAYERS)
    rec = serve_family(cfg, GEN, True, dev)
    rec["of_layers"] = get("qwen3-moe-30b-a3b").num_layers
    check(rec["peak_bytes"] <= 76 * 2**30, f"Qwen3 serving peaked at {rec['peak_bytes']} bytes")
    paths = {cfg.name: rec["launches"]}
    torch.cuda.empty_cache()
    # QWEN3_SPLIT_LAYERS of the 48 layers: a prefill of the serve's prompts
    # and the decode step's split, under the serve's memory limit
    full = dataclasses.replace(cfg, num_layers=QWEN3_SPLIT_LAYERS)
    # a decode step reads every weight but the embedding table (8 rows of
    # it) and, at the middle of the decode, the K/V rows up to pos
    step_bytes = (2 * (full.param_count() - full.vocab_size * full.d_model)
                  + 2 * full.num_layers * B * (pos + 1) * full.num_kv_heads
                  * full.resolved_head_dim * 2)
    torch.cuda.reset_peak_memory_stats(dev)
    m = LanguageModel(full)
    g = torch.Generator(device=dev)
    g.manual_seed(SERVE_SEED)
    params = m.cast_params(m.init(g))
    prompts = torch.from_numpy(np.random.default_rng(SERVE_SEED).integers(
        0, full.vocab_size, (REQUESTS, PROMPT_LEN)).astype(np.int32)).to(dev)
    torch.cuda.synchronize()
    tp = time.monotonic()
    logits, cache = m.prefill(params, prompts, max_seq)
    torch.cuda.synchronize()
    prefill_s = time.monotonic() - tp
    finite = bool(torch.isfinite(logits).all())
    step = decode_step_split(m, params, cache,
                             torch.zeros((REQUESTS, 1), dtype=torch.int32, device=dev))
    peak = torch.cuda.max_memory_allocated(dev)
    rec["full_size"] = {"layers": full.num_layers, "params": full.param_count(),
                        "prefill_s": prefill_s, "logits_finite": finite, "peak_bytes": peak,
                        "decode_step": step, "decode_step_bytes": step_bytes,
                        "decode_step_bound_ms": step_bytes / PEAK_BYTES_S * 1e3}
    check(finite, "Qwen3 at full size: non-finite prefill logits")
    check(peak <= 76 * 2**30, f"Qwen3 at full size peaked at {peak} bytes")
    del m, params, cache, logits
    torch.cuda.empty_cache()
    emit("qwen3_serve", seconds=time.monotonic() - t0, **rec, nvidia_smi=smi_line())

    # ---- 44. the other families served --------------------------------- #
    for name in FAMILIES[1:]:
        t0 = time.monotonic()
        full = get(name)
        cfg = dataclasses.replace(full, param_dtype="bfloat16",
                                  num_layers=DEPTH_CUTS.get(name, full.num_layers))
        arctic = name == "arctic-480b"
        rec = serve_family(cfg, ARCTIC_GEN if arctic else GEN, not arctic, dev)
        rec["of_layers"] = full.num_layers
        paths[name] = rec["launches"]
        emit("family_serve", seconds=time.monotonic() - t0, **rec, nvidia_smi=smi_line())

    for k in kernels:
        if k["name"] in shapes:
            k["family_shapes"] = shapes[k["name"]]
            k["family_max_abs_err"] = err[k["name"]]
            k["family_path_launches"] = {m: v[k["name"]] for m, v in paths.items()}


def scan_close(got, want, what: str) -> float:
    """Hold the scan kernel's ``(y, h)`` to its plain version's: the final
    state bit for bit, y within SCAN_Y_TOL of max|y|.  Returns y's largest
    absolute error."""
    import torch

    (y, h), (yw, hw) = got, want
    torch.cuda.synchronize()
    check(y.shape == yw.shape and h.shape == hw.shape and y.dtype == yw.dtype == torch.float32,
          f"{what}: y {tuple(y.shape)} / state {tuple(h.shape)} against {tuple(yw.shape)} / "
          f"{tuple(hw.shape)}")
    check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all()),
          f"{what}: non-finite output")
    differ = int((h.view(torch.int32) != hw.view(torch.int32)).sum())
    check(differ == 0, f"{what}: {differ} state entries differ from the plain version's "
          f"(max {float((h - hw).abs().max())})")
    err, scale = float((y - yw).abs().max()), float(yw.abs().max())
    check(err <= SCAN_Y_TOL * scale, f"{what}: y off by {err} (max|y| {scale})")
    return err


def scan_bound(B: int, S: int, din: int, ds: int, with_h0: bool) -> dict:
    """Least time of one launch: dt and x read and y written (f32), B and C
    rows and A read, the final state written and, given one, the initial
    state read; against the f32 operations of the recurrence."""
    entries = B * S * din * ds
    nbytes = 4 * (3 * B * S * din + 2 * B * S * ds + din * ds
                  + (2 if with_h0 else 1) * B * din * ds)
    nops = SCAN_OPS_PER_ENTRY * entries + B * S * din
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, nops / PEAK_F32_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else
            "operations", "bytes": nbytes, "ops": nops, "entry_updates": entries}


def rel_diff(got, want) -> float:
    """Largest difference of two tensors (any devices) over max|want|."""
    g, w = got.float().cpu(), want.float().cpu()
    return float((g - w).abs().max()) / float(w.abs().max())


def mamba_block_card_vs_cpu(cfg, dev) -> dict:
    """One Mamba block at ``cfg``'s full width, f32: a 2 x 64 prefill and
    4 decode steps on the card and on the CPU (the port's plain versions),
    each side from its own cache.  The init's constant leaves (``conv_b``,
    ``dt_b``, ``D_skip``) are drawn, so that they take part."""
    import torch
    from repro_torch.models import ssm

    din, B, S, steps = cfg.d_inner, 2, 64, 4
    g = torch.Generator(device=dev)
    g.manual_seed(SERVE_SEED)
    p_gpu = ssm.init_mamba(g, cfg, torch.float32)
    p_gpu["conv_b"] = 0.1 * torch.randn(din, generator=g, device=dev)
    p_gpu["dt_b"] = p_gpu["dt_b"] + torch.randn(din, generator=g, device=dev)
    p_gpu["D_skip"] = p_gpu["D_skip"] + 0.3 * torch.randn(din, generator=g, device=dev)
    xs = torch.randn((B, S + steps, cfg.d_model), generator=g, device=dev)

    def run(p, x, device):
        cache = {k: torch.zeros(s, dtype=d, device=device)
                 for k, (s, d) in ssm.mamba_cache_spec(cfg, B).items()}
        y, st = ssm.mamba_apply(p, x[:, :S], cfg, state_out=cache["ssm"])
        cache["conv"].copy_(st["conv"])
        out = {"prefill": y, "state": cache["ssm"].clone(), "conv": cache["conv"].clone()}
        for t in range(S, S + steps):
            y, st = ssm.mamba_apply(p, x[:, t:t + 1], cfg, cache, state_out=cache["ssm"])
            cache["conv"].copy_(st["conv"])
            out[f"decode{t - S}"] = y
        out["final_state"] = cache["ssm"]
        return out

    card = run(p_gpu, xs, dev)
    cpu = run({k: v.cpu() for k, v in p_gpu.items()}, xs.cpu(), torch.device("cpu"))
    d = {k: rel_diff(card[k], cpu[k]) for k in card if k != "conv"}
    # the windows: bf16 roundings of f32 values that differ by noise, so an
    # entry may sit one bf16 step (at most 2^-7 of its magnitude) from the
    # CPU's, or within the f32 tolerance of max|window| where the noise
    # flips a sign
    a, b = card["conv"].cpu().float(), cpu["conv"].float()
    slack = torch.maximum(a.abs(), b.abs()) * 2.0**-7 + MAMBA_CARD_CPU_TOL["state"] * float(
        b.abs().max())
    conv_far = int(((a - b).abs() > slack).sum())
    conv_differ = int((a != b).sum())
    check(d["prefill"] <= MAMBA_CARD_CPU_TOL["prefill"],
          f"Mamba block card vs CPU: prefill off by {d['prefill']} of max")
    check(d["state"] <= MAMBA_CARD_CPU_TOL["state"],
          f"Mamba block card vs CPU: state off by {d['state']} of max")
    check(conv_far == 0, f"Mamba block card vs CPU: {conv_far} conv window entries more than "
          f"a bf16 step apart ({d})")
    worst = max(v for k, v in d.items() if k.startswith("decode") or k == "final_state")
    check(worst <= MAMBA_CARD_CPU_TOL["decode_own_cache"],
          f"Mamba block card vs CPU: decode off by {worst} of max")
    return {"d_model": cfg.d_model, "d_inner": din, "d_state": cfg.ssm.d_state, "batch": B,
            "prompt": S, "decode_steps": steps, "max_over_max": d,
            "conv_entries_differing": conv_differ, "conv_entries": a.numel(),
            "tol": MAMBA_CARD_CPU_TOL}


def jamba_width_card_vs_cpu(cfg, dev) -> dict:
    """Jamba at a width cut (``cfg``), f32: a 2 x 64 prefill and 4 decode
    steps on the card and on the CPU, every MoE call's routing compared
    first (equal), then the logits: after the prefill, one step from the
    CPU's cache, and each side's own cache."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.store import map_with_keys
    from repro_torch.models import LanguageModel, RuntimeFlags

    flags = RuntimeFlags(compute_dtype=torch.float32)
    m_cpu, m_gpu = LanguageModel(cfg, flags), LanguageModel(cfg, flags)
    g = torch.Generator(device=dev)
    g.manual_seed(SERVE_SEED)
    p_gpu = m_gpu.init(g)
    p_cpu = map_with_keys(lambda _, x: x.cpu(), p_gpu)
    toks = torch.from_numpy(np.random.default_rng(SERVE_SEED).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32))
    steps, max_seq = 4, 64 + 16
    with RoutingTap() as tc:
        lc, cc = m_cpu.prefill(p_cpu, toks, max_seq)
    with RoutingTap() as tg:
        lg, cg = m_gpu.prefill(p_gpu, toks.to(dev), max_seq)
    mism = routing_mismatches(tc.calls, tg.calls)
    d = {"prefill": float((lg.cpu() - lc).abs().max())}
    tok = lc[:, -1].argmax(-1).to(torch.int32)[:, None]
    same_tokens = True
    for _ in range(steps):
        n0 = len(tc.calls)
        synced = {"pos": cc["pos"].to(dev, copy=True),
                  "blocks": tuple({k: v.to(dev, copy=True) for k, v in b.items()}
                                  for b in cc["blocks"])}
        with tc:
            lc, cc = m_cpu.decode_step(p_cpu, cc, tok)
        with RoutingTap() as ts:
            ls, _ = m_gpu.decode_step(p_gpu, synced, tok.to(dev))
        mism += routing_mismatches(tc.calls[n0:], ts.calls)
        d["decode_same_cache"] = max(d.get("decode_same_cache", 0.0),
                                     float((ls.cpu() - lc).abs().max()))
        lg, cg = m_gpu.decode_step(p_gpu, cg, tok.to(dev))
        d["decode_own_cache"] = max(d.get("decode_own_cache", 0.0),
                                    float((lg.cpu() - lc).abs().max()))
        same_tokens &= bool(torch.equal(lg.cpu().argmax(-1), lc.argmax(-1)))
        tok = lc[:, -1].argmax(-1).to(torch.int32)[:, None]
    check(mism == 0, f"Jamba card vs CPU, f32: {mism} MoE calls routed otherwise")
    for k, tol in JAMBA_CARD_CPU_TOL.items():
        check(d[k] <= tol, f"Jamba card vs CPU, f32: {k} logits differ by {d[k]} > {tol}")
    return {"layers": cfg.num_layers, "d_model": cfg.d_model, "experts": cfg.moe.num_experts,
            "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim],
            "vocab": cfg.vocab_size, "batch": 2, "prompt": 64, "decode_steps": steps,
            "max_abs_diff": d, "max_abs_logit": float(lc.abs().max()), "tol": JAMBA_CARD_CPU_TOL,
            "moe_calls": len(tc.calls), "routing_mismatched_calls": mism,
            "greedy_tokens_equal": same_tokens}


def hybrid_phases(dev, kernels: list, scan_regs: dict) -> None:
    """Phases 45-48: the selective-scan kernel against its plain version
    and timed, the attention kernels at the frontend families' shapes;
    one Mamba block at full width and Jamba at a width cut, card against
    CPU; Jamba served at full width (1 of 9 repeats, 8 of 16 experts);
    llava-next and musicgen served at full width, half depth, with their
    prefixes.
    Appends the scan kernel's entry to ``kernels`` and adds the new shapes
    and paths to the attention entries."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get
    from repro_torch.kernels import mamba as MB
    from repro_torch.kernels import ops
    from repro_torch.models import LanguageModel

    jamba = get(JAMBA)
    din, ds = jamba.d_inner, jamba.ssm.d_state
    n_mamba = sum(s.mixer == "mamba" for s in jamba.pattern)
    B, S = REQUESTS, PROMPT_LEN

    # ---- 45. the scan kernel; attention at the frontend shapes --------- #
    t0 = time.monotonic()
    cases, y_err = [], 0.0
    for name, b, s_, d_, ds_, with_h0, in_place, off in (
        ("prefill", B, S, din, ds, False, False, False),
        ("decode_in_place", B, 1, din, ds, True, True, False),
        ("s1_h0", 2, 1, 4096, ds, True, False, False),
        ("h0_s333", 2, 333, 4096, ds, True, False, False),
        ("chunk_edge_s17", 3, 17, 640, ds, True, False, False),
        ("ds8", 2, 100, 2048, 8, True, False, False),
        ("ds8_s1_in_place", 3, 1, 1000, 8, True, True, False),
        ("views_4_bytes_off_s1_in_place", 3, 1, 1000, ds, True, True, True),
        ("views_4_bytes_off_s37", 2, 37, 4100, 8, True, False, True),
    ):
        x = MB.sample_scan_inputs(b, s_, d_, ds_, seed=len(cases), device=dev, with_h0=with_h0)
        want = MB.selective_scan_ref(*x)
        emu = MB.selective_scan_kernel_order(*x)
        args = list(x)
        if off:  # A and the states 4 bytes into larger buffers: the kernels' 4-byte path
            args[2], args[5] = (torch.cat([v.new_zeros(1), v.reshape(-1)])[1:].view(v.shape)
                                for v in (x[2], x[5]))
        if in_place:
            cache = args[5] if off else args[5].clone()
            got = ops.selective_scan(*args[:5], cache, state_out=cache)
            check(got[1].data_ptr() == cache.data_ptr(), f"selective_scan/{name}: not in place")
        else:
            got = ops.selective_scan(*args)
        e = scan_close(got, want, f"selective_scan/{name}")
        check(same_bits(got[0], emu[0]),
              f"selective_scan/{name}: y differs from the torch emulation of its order")
        y_err = max(y_err, e)
        cases.append({"case": name, "shape": [b, s_, d_, ds_], "h0": with_h0,
                      "in_place": in_place, "state_4_bytes_off": off, "y_max_abs_err": e,
                      "y_max_abs": float(want[0].abs().max()), "state_bit_equal": True,
                      "y_bit_equal_to_kernel_order": True})
        del x, want, got, emu, args
    # libdevice's expf in the kernel against torch.exp on the card: with h0
    # ones and B zero the final state is exp(dt A) itself
    n = 1 << 20
    g = torch.Generator(device=dev)
    g.manual_seed(70)
    dt = torch.rand((1, 1, n), generator=g, device=dev) * 20
    A = -torch.rand((n, ds), generator=g, device=dev) * 5
    zero = torch.zeros((1, 1, ds), device=dev)
    _, h = ops.selective_scan(dt, torch.zeros_like(dt), A, zero, zero,
                              torch.ones((1, n, ds), device=dev))
    want = torch.exp(dt[0, 0, :, None] * A)
    exp_differ = int((h[0].view(torch.int32) != want.view(torch.int32)).sum())
    check(exp_differ == 0, f"selective_scan: expf differs from torch.exp in {exp_differ} of "
          f"{n * ds} values")
    del dt, A, h, want
    # times at the path's shapes: a prefill layer's launch (zero initial
    # state; 1.6 GB moved, 32x the L2), the SM clock sampled meanwhile;
    # one decode step's 7 launches, each on its own layer's state
    x = MB.sample_scan_inputs(B, S, din, ds, seed=80, device=dev, with_h0=False)
    clocks = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits", "-lms", "20"],
        stdout=subprocess.PIPE, text=True)
    try:
        clocks.stdout.readline()
        ms, out = device_ms([lambda: ops.selective_scan(*x)], samples=200)
    finally:
        clocks.terminate()
        mhz = [int(v) for v in clocks.communicate()[0].split() if v.isdigit()]
    pms, pout = device_ms([lambda: MB.selective_scan_ref(*x)], samples=5)
    scan_close(out, pout, "selective_scan (timed prefill) against its plain version")
    check(len(mhz) > 0, "nvidia-smi read no SM clock during the timed prefill")
    mhz_med = sorted(mhz)[len(mhz) // 2]
    bound = scan_bound(B, S, din, ds, with_h0=False)
    prefill_t = {"ms": ms, "plain_ms": pms, **bound,
                 "issue_floor_ms": SCAN_ISSUE_PER_ENTRY * bound["entry_updates"]
                 / (SMS * F32_LANES * mhz_med * 1e6) * 1e3,
                 "sm_clock_mhz": {"median": mhz_med, "min": min(mhz), "max": max(mhz),
                                  "samples": len(mhz)}}
    del x, out, pout
    layers = [MB.sample_scan_inputs(B, 1, din, ds, seed=90 + i, device=dev)
              for i in range(n_mamba)]
    outs = [torch.empty_like(v[5]) for v in layers]
    ms, out = device_ms([lambda v=v, o=o: ops.selective_scan(*v, state_out=o)
                         for v, o in zip(layers, outs)])
    pms, pout = device_ms([lambda v=v: MB.selective_scan_ref(*v) for v in layers])
    scan_close(out, pout, "selective_scan (timed decode) against its plain version")
    decode_t = {"ms": ms, "plain_ms": pms, **scan_bound(B, 1, din, ds, with_h0=True),
                "host_call_ms": eager_ms(lambda: ops.selective_scan(*layers[0],
                                                                    state_out=outs[0]), 200)}
    del layers, outs, out, pout
    tiny = MB.sample_scan_inputs(1, 1, 128, ds, seed=95, device=dev)
    tiny_out = torch.empty_like(tiny[5])
    launch_floor, _ = device_ms([lambda: ops.selective_scan(*tiny, state_out=tiny_out)] * n_mamba)
    # the attention kernels at the frontend families' prefill lengths
    attn = {"flash_attention_bhsd": [], "decode_attention_bhd": []}
    for i, name in enumerate(FRONTEND_FAMILIES):
        cfg = get(name)
        s_ = PROMPT_LEN + cfg.frontend_prefix
        rows = attn_shape_rows(name, B, s_, cfg.num_heads, cfg.num_kv_heads,
                               cfg.resolved_head_dim, s_ + FRONTEND_GEN + 8,
                               s_ + FRONTEND_GEN // 2 - 1, 600 + 10 * i, 700 + i, dev)
        for k, row in rows.items():
            attn[k].append(row)
    emit("hybrid_check", seconds=time.monotonic() - t0, cases=cases,
         exp_bits={"values": n * ds, "differing": exp_differ,
                   "note": "the kernel's libdevice expf against torch.exp on the card, "
                           "arguments dt A in [-100, 0]"},
         prefill=prefill_t, decode=decode_t, launch_floor_ms=launch_floor,
         registers=scan_regs, y_tol=SCAN_Y_TOL, attention_shapes=attn, attention_tol=ATTN_TOL,
         note="device_ms: CUDA graph of the calls, median of replays; issue_floor_ms: "
              f"{SCAN_ISSUE_PER_ENTRY} f32 instructions an entry update over {SMS} x "
              f"{F32_LANES} lanes at the median SM clock read during the timed prefill; "
              "launch_floor_ms: a 128-channel, one-token launch, 7 to a graph; no single "
              "PyTorch call computes the selective scan",
         nvidia_smi=smi_line())

    # ---- 46. a Mamba block and Jamba at a width cut: card against CPU -- #
    t0 = time.monotonic()
    block = mamba_block_card_vs_cpu(jamba, dev)
    width = dataclasses.replace(jamba, num_layers=JAMBA_LAYERS, d_model=1024, num_heads=8,
                                num_kv_heads=1, d_ff=2048, param_dtype="float32")
    cut = jamba_width_card_vs_cpu(width, dev)
    torch.cuda.empty_cache()
    emit("hybrid_card_vs_cpu", seconds=time.monotonic() - t0, mamba_block=block,
         jamba_width=cut)

    # ---- 47. Jamba at full width through serve() ----------------------- #
    t0 = time.monotonic()
    cfg = dataclasses.replace(jamba, num_layers=JAMBA_LAYERS, moe=dataclasses.replace(
        jamba.moe, num_experts=JAMBA_EXPERTS))
    rec = serve_family(cfg, GEN, True, dev)
    rec.update(of_layers=jamba.num_layers, experts=JAMBA_EXPERTS,
               of_experts=jamba.moe.num_experts)
    pos = PROMPT_LEN + GEN // 2 - 1
    # a decode step reads every weight but the embedding table, the K/V
    # rows up to pos of its attention layer, and reads and writes the Mamba
    # layers' states
    step_bytes = (2 * (cfg.param_count() - cfg.vocab_size * cfg.d_model)
                  + 2 * B * (pos + 1) * cfg.num_kv_heads * cfg.resolved_head_dim * 2
                  + n_mamba * 2 * 4 * B * din * ds)
    rec["decode_step_bytes"] = step_bytes
    rec["decode_step_bound_ms"] = step_bytes / PEAK_BYTES_S * 1e3
    check(rec["peak_bytes"] <= 76 * 2**30, f"Jamba serving peaked at {rec['peak_bytes']} bytes")
    torch.cuda.empty_cache()
    m = LanguageModel(cfg)
    g = torch.Generator(device=dev)
    g.manual_seed(SERVE_SEED)
    params = m.cast_params(m.init(g))
    prompts = torch.from_numpy(np.random.default_rng(SERVE_SEED).integers(
        0, cfg.vocab_size, (REQUESTS, PROMPT_LEN)).astype(np.int32)).to(dev)
    _, cache = m.prefill(params, prompts, PROMPT_LEN + GEN + 8)
    rec["decode_step"] = decode_step_split(
        m, params, cache, torch.zeros((REQUESTS, 1), dtype=torch.int32, device=dev))
    del m, params, cache
    torch.cuda.empty_cache()
    paths = {cfg.name: rec["launches"]}
    emit("jamba_serve", seconds=time.monotonic() - t0, **rec, nvidia_smi=smi_line())

    # ---- 48. llava-next and musicgen with their prefixes ---------------- #
    for name in FRONTEND_FAMILIES:
        t0 = time.monotonic()
        fcfg = dataclasses.replace(get(name), param_dtype="bfloat16",
                                   num_layers=FRONTEND_LAYERS[name])
        frec = serve_family(fcfg, FRONTEND_GEN, True, dev)
        frec["of_layers"] = get(name).num_layers
        paths[name] = frec["launches"]
        torch.cuda.empty_cache()
        emit("frontend_serve", seconds=time.monotonic() - t0, **frec, nvidia_smi=smi_line())

    for k in kernels:
        if k["name"] in attn:
            k["hybrid_shapes"] = attn[k["name"]]
            k["hybrid_max_abs_err"] = max(r["max_abs_err"] for r in attn[k["name"]])
            k["hybrid_path_launches"] = {m_: v[k["name"]] for m_, v in paths.items()}
    kernels.append({
        "name": "selective_scan", "route": "cuda", "source": SCAN_SOURCE,
        "replaces": SCAN_REPLACES, "launches": rec["launches"]["selective_scan"],
        "max_abs_err": y_err,
        **{k_: prefill_t[k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by",
                                        "issue_floor_ms")},
        "library_ms": None,
        "decode_ms": decode_t["ms"], "decode_plain_ms": decode_t["plain_ms"],
        "decode_bound_ms": decode_t["bound_ms"], "decode_bound_by": decode_t["bound_by"],
        "host_call_ms": decode_t["host_call_ms"], "launch_floor_ms": launch_floor,
        "registers": {name: v.get("registers") for name, v in scan_regs.items()},
        "shape": f"dt/x ({B}, {S}, {din}) f32, ds {ds}, zero initial state; decode "
                 f"({B}, 1, {din}) over a ({B}, {din}, {ds}) state",
        "note": "no TPU kernel: the reference's lax.scan; in the port one launch a call, "
                "of the decode kernel (S == 1) or the prefill kernel",
    })


# --------------------------------------------------------------------------- #
# Training the recurrent families: the WKV and scan backward kernels
# --------------------------------------------------------------------------- #
RWKV = "rwkv6-7b"
WKV_BWD_SOURCE = "src/repro_torch/kernels/csrc/rwkv6_bwd.cu"
SCAN_BWD_SOURCE = "src/repro_torch/kernels/csrc/mamba_scan_bwd.cu"
#: what each backward kernel takes the place of: jax.grad through the
#: reference's lax.scans (no TPU kernel: the Pallas WKV kernel has no VJP,
#: and the scan has no Pallas kernel)
WKV_BWD_REPLACES = "src/repro/models/ssm.py:218"
SCAN_BWD_REPLACES = SCAN_REPLACES
WKV_BWD_NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")
SCAN_BWD_NAMES = ("ddt", "dx", "dA", "dB", "dC", "dh0")
#: the backward kernels' reduced gradients against their plain versions', a
#: fraction of each gradient's max (other summation orders; the CPU tests
#: measure the plain versions' own reorderings at 3e-7); ds0 and dh0, the
#: carried gradient's elementwise chain, bit-equal
BWD_TOL = 1e-5
#: f32 operations a state entry and token: the WKV backward (the state
#: recomputed 3, dr 4, dkv 2, dk 2, dv 2, dw 2, G 3), the scan backward
#: (the state recomputed 5 with its exp, G 2, dB 2, dC 2, du 2, gz 2, ddt
#: 2, dA 2, the carried G 1, the exp again)
WKV_BWD_OPS_PER_ENTRY, SCAN_BWD_OPS_PER_ENTRY = 18, 20
BWD_SEED = 90
#: phase 50: RWKV6-7B at full width with 1 layer, and Jamba at phase 46's
#: width cut, f32, on a (batch, tokens) batch; card against CPU: the loss
#: (rel) and every gradient leaf's max abs diff over the leaf's max (phase
#: 38's bounds; RWKV6's gradients 5e-4: its time mix amplifies rounding
#: noise, as reordering the WKV's y sum alone on the CPU moves them by
#: 2.1e-5, and the card, with the plain recurrences in place of the
#: kernels, sits 1.60e-4 from the CPU); the kernels against the plain
#: recurrences, both on the card, 1e-4 (measured 2.4e-5 / 4.3e-6)
SSM_CHECK_BATCH = (2, 32)
SSM_CHECK_TOL = {"loss": 1e-5, "grad": {"rwkv": 5e-4, "mamba": 1e-4},
                 "kernels_vs_plain_on_card": 1e-4}
#: phase 51: the training cuts at full width.  RWKV6-7B at 4 of its 32
#: layers (1.41 B parameters; f32 masters, bf16 compute); Jamba at the first
#: two layers of its pattern, (Mamba, dense) and (Mamba, MoE), with 2 of its
#: 16 experts, top-2 kept (3.72 B; bf16 parameters, 8-bit AdamW moments).
#: At 4 experts (4.93 B) the card ran out of memory in the AdamW update (its
#: f32 temporaries of the (4, 8192, 24576) expert stacks, 3 GB each, at 67.8
#: GiB allocated and 8.3 GiB reserved), so the cut keeps 2.
#: 8 x 1024 tokens a step.  The fault-free run takes no checkpoint (its
#: MTBF prior is 1e9 s), so that its step times are the steps'.  The
#: faulted run's executor runs on a simulated clock (train()'s sim_step_s,
#: each family's step as measured on the H100), so its faults, predictions
#: and saves fall at the same steps on every host; a wall-clock schedule
#: had put a fault inside Jamba's run on one host and none on another.
#: Seed 3 and these MTBFs (simulated seconds) give each run one save, a
#: fault restored from the memory tier and a second one from the disk
#: (every second restore of a checkpoint loses the buddy's replica):
#: RWKV6 saves step 4, Jamba step 4 (its bf16 leaves read back by the
#: manifest's dtype).  tests/test_torch_executor.py replays both schedules
#: on the CPU.  A save costs what it costs on the wall clock: the RWKV6
#: cut's 16.9 GB measured c_block 12.2-17.3 s and c_full 18.3 s (8.5 GB:
#: int8 codes, the second moments raw), Jamba's 15.0 GB (raw) c_block
#: 14-21 s and c_full 29-36 s, which the restore after it waits for.
#: After an int8 disk restore the last loss is held to SSM_LOSS_RTOL (the
#: RWKV6 cut's f32 masters, the decays' w0 among them, come back within
#: half a code step of their block: 4.7e-3 three steps after it; 7.8e-2
#: while the second moments were coded too; Jamba's bf16 and int8 leaves
#: and its second moments' scales are stored raw)
#: (RWKV6 at 2 layers to keep the script inside its time limit)
RWKV_TRAIN_LAYERS, JAMBA_TRAIN_EXPERTS = 2, 2
SSM_TRAIN_SEED = 3
SSM_TRAIN = {"rwkv": {"steps": 8, "mtbf": 2.5, "sim_step_s": 0.32},
             "jamba": {"steps": 6, "mtbf": 4.0, "sim_step_s": 0.97}}
SSM_LOSS_RTOL = {"rwkv": 5e-2, "jamba": TRAIN_LOSS_RTOL}
SSM_PEAK_LIMIT = 76 * 2**30


def wkv_bwd_case(B, S, H, hd, seed, dev, with_s0, with_dsT):
    """Inputs of a WKV backward: the forward's (the kernel test's laws),
    ``dy`` and ``dsT`` (or None) ~ N(0, 1) / 0.1 N(0, 1) from a seeded
    card generator."""
    import torch
    from repro_torch.kernels import rwkv6 as RW

    r, k, v, w, u, s0 = RW.sample_wkv_inputs(B, S, H, hd, seed, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    dy = torch.randn((B, S, H, hd), generator=g, device=dev)
    dsT = torch.randn((B, H, hd, hd), generator=g, device=dev) * 0.1 if with_dsT else None
    return r, k, v, w, u[None], (s0 if with_s0 else None), dy, dsT


def scan_bwd_case(B, S, din, ds, seed, dev, with_h0, with_dhT):
    """Inputs of a scan backward: the forward's (Mamba's laws), ``dy`` and
    ``dhT`` (or None) from a seeded card generator."""
    import torch
    from repro_torch.kernels import mamba as MB

    dt, x, A, Bc, Cc, h0 = MB.sample_scan_inputs(B, S, din, ds, seed, device=dev,
                                                 with_h0=with_h0)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    dy = torch.randn((B, S, din), generator=g, device=dev)
    dhT = torch.randn((B, din, ds), generator=g, device=dev) * 0.1 if with_dhT else None
    return dt, x, A, Bc, Cc, h0, dy, dhT


def bwd_close(got, want, names, exact: str, what: str) -> dict:
    """Hold a backward kernel's gradients to its plain version's: ``exact``
    bit for bit, the others within BWD_TOL of their max.  Returns each
    gradient's largest absolute error."""
    import torch

    torch.cuda.synchronize()
    errs = {}
    for name, a, b in zip(names, got, want):
        if b is None:
            check(a is None, f"{what}: {name} given where the plain version has none")
            continue
        check(a.shape == b.shape and a.dtype == torch.float32
              and bool(torch.isfinite(a).all()), f"{what}: {name} {tuple(a.shape)} "
              f"against {tuple(b.shape)}, or not finite")
        if name == exact:
            differ = int((a.view(torch.int32) != b.view(torch.int32)).sum())
            check(differ == 0, f"{what}: {differ} entries of {name} differ from the plain "
                  f"version's (max {float((a - b).abs().max())})")
            errs[name] = 0.0
            continue
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        check(err <= BWD_TOL * scale, f"{what}: {name} off by {err} (max {scale})")
        errs[name] = err
    return errs


def bits_digest(tensors) -> str:
    """sha256 of the tensors' bytes (None skipped), to compare runs."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def wkv_bwd_bound(B, S, H, hd, with_s0: bool) -> dict:
    """Least time of one backward: r, k, v, w, dy read and dr, dk, dv, dw
    written (f32), u read and du written, s0 read and ds0 written when
    given; against the f32 operations of the reverse recurrence."""
    n = B * S * H * hd
    nbytes = 4 * (9 * n + 2 * H * hd + (2 * B * H * hd * hd if with_s0 else 0))
    nops = WKV_BWD_OPS_PER_ENTRY * n * hd
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, nops / PEAK_F32_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else
            "operations", "bytes": nbytes, "ops": nops}


def scan_bwd_bound(B, S, din, ds, with_h0: bool) -> dict:
    """Least time of one backward: dt, x, dy read and ddt, dx written, B,
    C read and dB, dC written, A read and dA written (f32), h0 read and
    dh0 written when given; against the f32 operations of the reverse
    recurrence."""
    nbytes = 4 * (5 * B * S * din + 4 * B * S * ds + 2 * din * ds
                  + (2 * B * din * ds if with_h0 else 0))
    nops = SCAN_BWD_OPS_PER_ENTRY * B * S * din * ds
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, nops / PEAK_F32_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else
            "operations", "bytes": nbytes, "ops": nops}


def draw_constant_leaves(params: dict, g, dev) -> None:
    """Draw, in place, the leaves the reference's init leaves constant (the
    time mix's ``u``, ``w0``, ``mu``, ``ln``, the channel mix's ``mu``;
    Mamba's ``dt_b``, ``D_skip``, ``conv_b``), so that their gradients and
    the paths through them are exercised."""
    import torch

    def rn(x, scale, shift=0.0):
        return (torch.randn(x.shape, generator=g, device=dev) * scale + shift).to(x.dtype)

    def ru(x, lo, hi):
        return (torch.rand(x.shape, generator=g, device=dev) * (hi - lo) + lo).to(x.dtype)

    for blk in params["blocks"]:
        mx, mlp = blk["mixer"], blk["mlp"]
        if "u" in mx:
            mx["u"], mx["w0"] = rn(mx["u"], 0.5), rn(mx["w0"], 0.5, -0.5)
            mx["mu"], mx["ln"] = ru(mx["mu"], 0.0, 1.0), ru(mx["ln"], 0.5, 1.5)
            mlp["mu"] = ru(mlp["mu"], 0.0, 1.0)
        if "dt_b" in mx:
            mx["dt_b"] = mx["dt_b"] + rn(mx["dt_b"], 1.0)
            mx["D_skip"], mx["conv_b"] = rn(mx["D_skip"], 0.3, 1.0), rn(mx["conv_b"], 0.1)


def ssm_grads_card_vs_cpu(cfg, dev) -> dict:
    """``cfg`` in f32 on a SSM_CHECK_BATCH batch: the loss and every
    gradient leaf on the card (the forward and backward kernels) against
    the port on the CPU (their plain versions), MoE routing compared."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.store import map_with_keys
    from repro_torch.kernels import mamba as MB
    from repro_torch.kernels import rwkv6 as RW
    from repro_torch.models import LanguageModel, RuntimeFlags

    m = LanguageModel(cfg, RuntimeFlags(compute_dtype=torch.float32))
    g = torch.Generator(device=dev)
    g.manual_seed(TRAIN_CHECK_SEED)
    p_gpu = m.init(g)
    draw_constant_leaves(p_gpu, g, dev)
    p_cpu = map_with_keys(lambda _, x: x.cpu(), p_gpu)
    B, S = SSM_CHECK_BATCH
    toks = torch.from_numpy(np.random.default_rng(TRAIN_CHECK_SEED).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
    c0 = (RW.wkv6_bhsd.launches, RW.wkv6_bwd.launches, MB.selective_scan.launches,
          MB.selective_scan_bwd.launches)
    with RoutingTap() as tg:
        l_gpu, g_gpu = loss_and_grads(m, p_gpu, {"tokens": toks.to(dev)})
    torch.cuda.synchronize()
    c1 = (RW.wkv6_bhsd.launches, RW.wkv6_bwd.launches, MB.selective_scan.launches,
          MB.selective_scan_bwd.launches)
    # the same step on the card with the recurrences' plain versions in
    # place of their kernels (forward and backward): separates the kernels'
    # share of the card-CPU distance from the rest of the step's
    patched = {(RW, "_run"): lambda name, r, k, v, w, u3, s0, so, tr: RW.wkv_ref(
                   r, k, v, w, u3, s0),
               (RW, "wkv6_bwd"): RW.wkv_bwd_ref,
               (MB, "_run"): lambda dt, x, A, Bc, Cc, h0, so: MB.selective_scan_ref(
                   dt, x, A, Bc, Cc, h0),
               (MB, "selective_scan_bwd"): MB.selective_scan_bwd_ref}
    real = {key: getattr(*key) for key in patched}
    try:
        for (mod, name), f in patched.items():
            setattr(mod, name, f)
        with RoutingTap() as tp:
            l_pl, g_pl = loss_and_grads(m, p_gpu, {"tokens": toks.to(dev)})
    finally:
        for (mod, name), f in real.items():
            setattr(mod, name, f)
    with RoutingTap() as tc:
        l_cpu, g_cpu = loss_and_grads(m, p_cpu, {"tokens": toks})
    g_pl = {k: v.cpu() for k, v in g_pl.items()}
    mism = routing_mismatches(tc.calls, tg.calls) + routing_mismatches(tc.calls, tp.calls)
    check(mism == 0, f"{cfg.name} grads card vs CPU: {mism} MoE calls routed otherwise")

    def by_leaf(got, want):
        rel = {k: float((got[k].detach().cpu() - w.cpu()).abs().max())
               / (float(w.abs().max()) or 1.0) for k, w in want.items()}
        return dict(sorted(rel.items(), key=lambda kv: -kv[1])[:6])

    fam = "rwkv" if any(sp.mixer == "rwkv" for sp in cfg.pattern) else "mamba"
    tol = {"loss": SSM_CHECK_TOL["loss"], "grad": SSM_CHECK_TOL["grad"][fam],
           "kernels_vs_plain_on_card": SSM_CHECK_TOL["kernels_vs_plain_on_card"]}
    d = {"loss": abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu)),
         "grad": leaf_rel(g_gpu, g_cpu), "kernels_vs_plain_on_card": leaf_rel(g_gpu, g_pl)}
    worst = {"card_vs_cpu": by_leaf(g_gpu, g_cpu),
             "card_kernels_vs_card_plain": by_leaf(g_gpu, g_pl),
             "card_plain_vs_cpu": by_leaf(g_pl, g_cpu),
             "loss_card_plain_vs_cpu": abs(float(l_pl) - float(l_cpu)) / abs(float(l_cpu))}
    del g_pl
    late = [(v <= tol[k], f"{cfg.name} card vs CPU: {k} off by {v} > {tol[k]}")
            for k, v in d.items()]
    launches = dict(zip(("wkv6_bhsd", "wkv6_bwd", "selective_scan", "selective_scan_bwd"),
                        (b - a for a, b in zip(c0, c1))))
    n_rwkv = sum(s.mixer == "rwkv" for s in cfg.pattern) * cfg.n_repeats
    n_mamba = sum(s.mixer == "mamba" for s in cfg.pattern) * cfg.n_repeats
    want = {"wkv6_bhsd": n_rwkv, "wkv6_bwd": n_rwkv, "selective_scan": n_mamba,
            "selective_scan_bwd": n_mamba}
    check(launches == want, f"{cfg.name} card step launches {launches}, wanted {want}")
    return {"arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
            "params": cfg.param_count(), "batch": [B, S], "compute": "float32",
            "loss": float(l_gpu), "rel_diff": d, "tol": tol, "launches": launches,
            "worst_leaves": worst, "moe_calls": len(tc.calls),
            "routing_mismatched_calls": mism, "leaves": len(g_cpu), "late_checks": late}


def train_state_bytes(cfg) -> int:
    """Bytes of ``cfg``'s training state: the parameters in their dtype and
    the AdamW moments (two f32, or two int8 with an f32 scale a block of
    256)."""
    n = cfg.param_count()
    moments = 2 * n * 4 if cfg.optimizer != "adamw8bit" else 2 * (n + n // 256 * 4)
    return n * (4 if cfg.param_dtype == "float32" else 2) + moments


def ssm_train_run(cfg, dev, steps: int, mtbf: float, sim_step_s: float) -> dict:
    """``train()`` on ``cfg`` at full width, fault-free (no checkpoint) and
    faulted (paper-accurate predictor, int8 store behind the buddy memory
    tier, every second restore of a checkpoint from the disk; faults of
    mean ``mtbf`` on the executor's clock of ``sim_step_s`` a step), under
    ``torch.use_deterministic_algorithms``; each run's kernel launches
    (counters reset just before it and read just after), peak memory and
    the records ``train()`` returns."""
    import gc

    import torch
    from repro_torch.kernels import ckpt_codec as CK
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import mamba as MB
    from repro_torch.kernels import rwkv6 as RW
    from repro_torch.launch.train import train
    from repro_torch.models import RuntimeFlags

    wrappers = {"wkv6_bhsd": RW.wkv6_bhsd, "wkv6_bwd": RW.wkv6_bwd,
                "selective_scan": MB.selective_scan, "selective_scan_bwd": MB.selective_scan_bwd,
                "quantize_blocks": CK.quantize_blocks, "dequantize_blocks": CK.dequantize_blocks,
                "flash_attention_bhsd": FA.flash_attention_bhsd}
    kw = dict(steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR, seed=SSM_TRAIN_SEED,
              codec="int8", memory_tier=True, correlated_every=TRAIN_CORRELATED_EVERY,
              predictor="paper-accurate", strategy="auto", sim_step_s=sim_step_s,
              flags=RuntimeFlags(dense_attn_max=512), device=dev, log=lambda s: None)
    runs = {}
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        for name, inject in (("fault_free", False), ("faulted", True)):
            m = mtbf if inject else 1e9
            for w in wrappers.values():
                w.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.monotonic()
            r = train(cfg, inject_faults=inject, fault_mtbf=m, **kw)
            torch.cuda.synchronize()
            r["seconds"] = time.monotonic() - t0
            r["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            r["launches"] = {k: w.launches for k, w in wrappers.items()}
            r["mtbf"] = m
            runs[name] = r
            # the run's executor and its restore tiers' closures form a cycle
            # that holds its training state (~20 GB) until a collection
            gc.collect()
            torch.cuda.empty_cache()
            emit("ssm_train_run", arch=cfg.name, run=name, seconds=r["seconds"],
                 wall_s=r["wall_s"], clock_s=r["clock_s"], steps_run=len(r["step_s"]),
                 step_ms=[t * 1e3 for _, t in r["step_s"]], mtbf=m,
                 saves=r["saves"], restores=r["restores"], peak_bytes=r["peak_bytes"],
                 allocated_after=torch.cuda.memory_allocated(dev), launches=r["launches"])
    finally:
        torch.use_deterministic_algorithms(False)
    return runs


def summarize_train(cfg, runs: dict, steps: int) -> tuple:
    """The phase-51 record of one family and its checks, ``(ok, message)``
    pairs: every step's loss finite, the faulted run's faults restored, one
    of them from the memory tier and one from the disk, its
    losses bit-equal to the fault-free run's up to the first disk restore
    and the last within TRAIN_LOSS_RTOL, the recurrence kernels launched
    forward and backward, no flash launch, peak memory under
    SSM_PEAK_LIMIT."""
    import statistics

    from repro_torch.core.waste import waste_exact

    clean, hit = runs["fault_free"], runs["faulted"]
    rep, last, tokens = hit["report"], steps - 1, TRAIN_BATCH * TRAIN_SEQ
    mtbf = hit["mtbf"]
    checks = []
    disk = [e for e in hit["restores"] if e["tier"] == "disk"]
    first_disk = min((e["step"] for e in disk), default=steps)
    unequal = [k for k in range(first_disk) if hit["losses"].get(k) != clean["losses"].get(k)]
    rel_last = abs(hit["losses"][last] - clean["losses"][last]) / abs(clean["losses"][last])
    rec = "rwkv" if any(s.mixer == "rwkv" for s in cfg.pattern) else "jamba"
    fwd, bwd = (("wkv6_bhsd", "wkv6_bwd") if rec == "rwkv"
                else ("selective_scan", "selective_scan_bwd"))
    summary = {}
    for name, r in runs.items():
        rp = r["report"]
        ls = r["losses"]
        what = f"ssm_train/{cfg.name}/{name}"
        n_run = len(r["step_s"])
        checks += [(sorted(ls) == list(range(steps)), f"{what}: steps {sorted(ls)}"),
                   (all(math.isfinite(v) for v in ls.values()), f"{what}: non-finite loss"),
                   (r["launches"]["flash_attention_bhsd"] == 0,
                    f"{what}: the flash kernel ran in training"),
                   (r["peak_bytes"] <= SSM_PEAK_LIMIT, f"{what}: peak {r['peak_bytes']} bytes")]
        checks += [(r["launches"][k] >= n_run,
                    f"{what}: {k} launched {r['launches'][k]} times in {n_run} steps")
                   for k in (fwd, bwd)]
        step_ms = statistics.median(s for _, s in r["step_s"]) * 1e3
        r_meas = rp.ledger.recovery / rp.n_restores if rp.n_restores else 0.0
        rc, pc = (0.85, 0.82) if name == "faulted" else (0.0, 1.0)
        summary[name] = {
            "seconds": r["seconds"], "wall_s": r["wall_s"], "clock_s": r["clock_s"],
            "step_ms_median": step_ms,
            "step_ms_min": min(s for _, s in r["step_s"]) * 1e3, "steps_run": n_run,
            "tokens_per_s_step": tokens / step_ms * 1e3,
            "tokens_per_s_wall": steps * tokens / r["wall_s"],
            "losses": [ls[k] for k in range(steps)], "saves": r["saves"],
            "c_estimate": rp.c_estimate, "period_T": rp.period_T, "q": rp.q,
            "counts": {"periodic": rp.n_periodic, "proactive": rp.n_proactive,
                       "faults": rp.n_faults, "restores": rp.n_restores},
            "restores": r["restores"], "ledger": rp.ledger.as_dict(),
            "analytic_waste": rp.analytic_waste, "mtbf": r["mtbf"],
            "waste_exact_own": (float(waste_exact(rp.period_T, rp.q, rp.c_estimate, 0.2,
                                                  r_meas, mtbf, rc, pc))
                                if name == "faulted" else None),
            "launches": r["launches"],
            "launches_per_step_run": {k: r["launches"][k] / max(n_run, 1) for k in (fwd, bwd)},
            "peak_bytes": r["peak_bytes"],
        }
    tiers = [e["tier"] for e in hit["restores"]]
    checks += [(rep.n_faults >= 2 and rep.n_restores == rep.n_faults,
                f"ssm_train/{cfg.name}: {rep.n_faults} faults, {rep.n_restores} restores"),
               ("memory" in tiers and "disk" in tiers,
                f"ssm_train/{cfg.name}: restores from {tiers}, wanted memory and disk"),
               (not unequal, f"ssm_train/{cfg.name}: steps {unequal} differ from the "
                "fault-free run before any disk restore"),
               (rel_last <= SSM_LOSS_RTOL[rec], f"ssm_train/{cfg.name}: last loss "
                f"{hit['losses'][last]} vs {clean['losses'][last]} (rel {rel_last})")]
    return {"arch": cfg.name, "layers": cfg.num_layers,
            "pattern": [[s.mixer, s.mlp] for s in cfg.pattern],
            "experts": cfg.moe.num_experts if cfg.moe else None, "params": cfg.param_count(),
            "param_dtype": cfg.param_dtype, "optimizer": cfg.optimizer, "compute": "bfloat16",
            "batch": [TRAIN_BATCH, TRAIN_SEQ], "steps": steps, "mtbf": mtbf,
            "seed": SSM_TRAIN_SEED, "sim_step_s": SSM_TRAIN[rec]["sim_step_s"],
            "fault_times": [t for t in hit["fault_times"] if t <= hit["clock_s"]],
            "runs": summary, "bit_equal_steps": first_disk - len(unequal),
            "first_disk_restore_step": first_disk, "last_loss_rel_diff": rel_last,
            "state_bytes": train_state_bytes(cfg), "tol": SSM_LOSS_RTOL[rec]}, checks


def remat_check(cfg, dev) -> dict:
    """Phase 52: one step's loss and gradients of ``cfg`` (bf16 compute,
    8 x 1024 tokens) under remat "none", "full" and "dots", bit-equal
    across the three (deterministic algorithms); each policy's step ms
    (CUDA events, median of 2 after a warm-up) and its peak memory above
    what was resident before the step."""
    import statistics

    import numpy as np
    import torch
    from repro_torch.kernels import rwkv6 as RW
    from repro_torch.models import LanguageModel, RuntimeFlags

    toks = torch.from_numpy(np.random.default_rng(TRAIN_SEED).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)).to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(TRAIN_SEED)
    params = LanguageModel(cfg).init(g)
    out, want = {}, None
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        for pol in ("none", "full", "dots"):
            m = LanguageModel(cfg, RuntimeFlags(remat_policy=pol, dense_attn_max=512))
            loss_and_grads(m, params, {"tokens": toks})
            ms = []
            for i in range(2):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                f0 = RW.wkv6_bhsd.launches
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                loss, grads = loss_and_grads(m, params, {"tokens": toks})
                b.record()
                torch.cuda.synchronize()
                ms.append(a.elapsed_time(b))
                peak = torch.cuda.max_memory_allocated(dev) - base
                fwd = RW.wkv6_bhsd.launches - f0
                if i == 0:
                    continue
                if want is None:
                    want = (loss, grads)
                    same = True
                else:
                    same = bool(torch.equal(loss, want[0])) and all(
                        torch.equal(v, want[1][k]) for k, v in grads.items())
                    check(same, f"remat {pol}: loss or gradients differ from remat none")
                del grads
            out[pol] = {"step_ms": statistics.median(ms), "peak_bytes_above_resident": peak,
                        "wkv_forward_launches": fwd, "loss": float(loss),
                        "bit_equal_to_none": same}
    finally:
        torch.use_deterministic_algorithms(False)
    del want, params
    return out


def ssm_train_phases(dev, kernels: list, bwd_regs: dict) -> None:
    """Phases 49-52: the WKV and scan backward kernels against their plain
    versions, timed; RWKV6 and Jamba loss and gradients card against CPU;
    ``train()`` on RWKV6-7B and Jamba-1.5-Large at full width under faults;
    remat on the RWKV6 cut.  Appends the two backward kernels' entries to
    ``kernels`` and adds the training path's launches to the WKV, scan and
    codec entries.  ``bwd_regs``: ptxas's registers, static shared memory
    and spills of the backward kernels, from the build."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import get
    from repro_torch.kernels import mamba as MB
    from repro_torch.kernels import rwkv6 as RW

    rwkv, jamba = get(RWKV), get(JAMBA)
    H, hd = rwkv.rwkv_heads, rwkv.ssm.rwkv_head_dim
    din, ds = jamba.d_inner, jamba.ssm.d_state
    B, S = TRAIN_BATCH, TRAIN_SEQ

    # ---- 49. the backward kernels against their plain versions --------- #
    t0 = time.monotonic()
    entries = {}
    for kname, names, exact, case_fn, fn, ref, cases, bound_fn in (
        ("wkv6_bwd", WKV_BWD_NAMES, "ds0", wkv_bwd_case, RW.wkv6_bwd, RW.wkv_bwd_ref, (
            ("train", B, S, H, hd, False, False), ("s1_s0", 2, 1, H, hd, True, True),
            ("s37_s0", 2, 37, 8, hd, True, True), ("s333", 2, 333, 4, hd, True, False),
            ("hd16_s37", 2, 37, 4, 16, True, True)), wkv_bwd_bound),
        ("selective_scan_bwd", SCAN_BWD_NAMES, "dh0", scan_bwd_case, MB.selective_scan_bwd,
         MB.selective_scan_bwd_ref, (
            ("train", B, S, din, ds, False, False), ("s1_h0", 2, 1, 4096, ds, True, True),
            ("s37_h0", 2, 37, 4096, ds, True, True), ("s333", 2, 333, 2048, ds, True, False),
            ("ds8", 2, 100, 2048, 8, True, True)), scan_bwd_bound),
    ):
        rows, errs = [], {}
        for i, (case, *shape, with_0, with_T) in enumerate(cases):
            x = case_fn(*shape, BWD_SEED + i, dev, with_0, with_T)
            n0 = fn.launches
            got = fn(*x)
            check(fn.launches == n0 + 1, f"{kname}/{case}: {fn.launches - n0} launches")
            e = bwd_close(got, ref(*x), names, exact, f"{kname}/{case}")
            for k, v in e.items():
                errs[k] = max(errs.get(k, 0.0), v)
            row = {"case": case, "shape": shape, "initial_state": with_0,
                   "final_state_grad": with_T, "max_abs_err": e}
            if case == "train":
                again = fn(*x)
                torch.cuda.synchronize()
                same = all((a is None and b is None) or bool(torch.equal(a, b))
                           for a, b in zip(got, again))
                check(same, f"{kname}/train: a second call gave other bits")
                row["bits_sha256"] = bits_digest(got)
                del again
                ms, _ = device_ms([lambda x=x: fn(*x)])
                pms, _ = device_ms([lambda x=x: ref(*x)], samples=1)
                timing = {"ms": ms, "plain_ms": pms, **bound_fn(*shape, with_0)}
                stem = "wkv6_bwd_" if kname == "wkv6_bwd" else "scan_bwd_"
                row.update(timing, repeat_bit_equal=same,
                           device_kernels=kernel_split(lambda x=x: fn(*x)),
                           ptxas={k: v for k, v in bwd_regs.items() if stem in k})
            rows.append(row)
            del x, got
            torch.cuda.empty_cache()
        entries[kname] = {"rows": rows, "errs": errs, "timing": timing}
    emit("ssm_bwd_check", seconds=time.monotonic() - t0,
         **{k: v["rows"] for k, v in entries.items()}, tol=BWD_TOL,
         note="each backward kernel against its plain version on the card: ds0 / dh0 bit "
              "for bit, the reduced gradients within tol of their max; train: RWKV6-7B's "
              "8 x 1024 x 64 heads x 64 and Jamba's 8 x 1024 x 16384 x ds 16 from a zero "
              "state, timed (device_ms: a CUDA graph of the call, median of replays; the "
              "plain version's graph of its per-token loop), bits_sha256 of its outputs for "
              "comparing runs, device_kernels: each device kernel of the call in a "
              "torch.profiler trace (ms a launch, registers, shared memory, the trace's "
              "estimated occupancy), ptxas: the build's registers, static shared memory "
              "and spills of each instantiation; no single PyTorch call computes either "
              "backward",
         nvidia_smi=smi_line())

    # ---- 50. loss and gradients, card against CPU ---------------------- #
    t0 = time.monotonic()
    r1 = ssm_grads_card_vs_cpu(dataclasses.replace(rwkv, num_layers=1), dev)
    torch.cuda.empty_cache()
    width = dataclasses.replace(jamba, num_layers=JAMBA_LAYERS, d_model=1024, num_heads=8,
                                num_kv_heads=1, d_ff=2048, param_dtype="float32")
    j1 = ssm_grads_card_vs_cpu(width, dev)
    torch.cuda.empty_cache()
    late = r1.pop("late_checks") + j1.pop("late_checks")
    emit("ssm_train_card_vs_cpu", seconds=time.monotonic() - t0, rwkv=r1, jamba_width=j1)

    # ---- 51. train() on both cuts under faults ------------------------- #
    cuts = {
        "rwkv": dataclasses.replace(rwkv, num_layers=RWKV_TRAIN_LAYERS),
        "jamba": dataclasses.replace(jamba, num_layers=2, pattern=jamba.pattern[:2],
                                     moe=dataclasses.replace(jamba.moe,
                                                             num_experts=JAMBA_TRAIN_EXPERTS)),
    }
    path = {}
    for fam, cfg in cuts.items():
        t0 = time.monotonic()
        kw = SSM_TRAIN[fam]
        runs = ssm_train_run(cfg, dev, kw["steps"], kw["mtbf"], kw["sim_step_s"])
        rec, checks = summarize_train(cfg, runs, kw["steps"])
        del runs
        gc.collect()
        torch.cuda.empty_cache()
        fw, bw = (RW.wkv6_bhsd, RW.wkv6_bwd) if fam == "rwkv" else (MB.selective_scan,
                                                                    MB.selective_scan_bwd)
        rec["step_split"] = train_step_split(
            cfg, dev, {fw.__name__: lambda fw=fw: fw.launches,
                       bw.__name__: lambda bw=bw: bw.launches}, phase="ssm_train_split")
        torch.cuda.empty_cache()
        path[fam] = rec
        emit("ssm_train_path", seconds=time.monotonic() - t0, family=fam, **rec,
             nvidia_smi=smi_line(),
             compared="losses before the first disk restore bit-equal to the fault-free "
                      "run's (torch.use_deterministic_algorithms); the last step's within "
                      "tol (int8 disk restore)")
        for ok, msg in checks:
            check(ok, msg)

    # ---- 52. remat on the RWKV6 cut ------------------------------------ #
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    remat = remat_check(cuts["rwkv"], dev)
    torch.cuda.empty_cache()
    emit("ssm_remat", seconds=time.monotonic() - t0, arch=cuts["rwkv"].name,
         layers=RWKV_TRAIN_LAYERS, batch=[B, S], compute="bfloat16", policies=remat,
         note="one step's loss and every gradient leaf bit-equal across the policies; peak: "
              "max_memory_allocated over what was resident before the step")

    for ok, msg in late:  # phase 50's bounds, held after phases 51-52 have run
        check(ok, msg)
    faulted = {fam: path[fam]["runs"]["faulted"]["launches"] for fam in path}
    for k in kernels:
        if k["name"] in ("wkv6_bhsd", "quantize_blocks", "dequantize_blocks",
                         "selective_scan"):
            k["ssm_train_path_launches"] = {fam: faulted[fam][k["name"]] for fam in faulted}
    for kname, fam, source, replaces in (
        ("wkv6_bwd", "rwkv", WKV_BWD_SOURCE, WKV_BWD_REPLACES),
        ("selective_scan_bwd", "jamba", SCAN_BWD_SOURCE, SCAN_BWD_REPLACES),
    ):
        tm = entries[kname]["timing"]
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": faulted[fam][kname],
            "max_abs_err": max(entries[kname]["errs"].values()),
            "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"], "library_ms": None,
            "max_abs_err_by_gradient": entries[kname]["errs"],
            "fault_free_launches": path[fam]["runs"]["fault_free"]["launches"][kname],
            "note": "no TPU kernel: the backward of the reference's lax.scan (jax.grad); "
                    "launches: the faulted training run of phase 51 (replays included)",
        })


# --------------------------------------------------------------------------- #
# The distributed layer (phase 53)
# --------------------------------------------------------------------------- #
QWEN3 = "qwen3-moe-30b-a3b"
PAR_LAYERS = 2
PAR_BATCH = (8, 1024)
PAR_SEED = 0
PAR_STEPS = 2
#: expert-parallel shares run in turn: M ranks of the model axis
PAR_EP_M = 8
#: the shares summed in rank order against moe_apply, of max|y| (the same
#: pairs; a token's outputs summed in another association, each add
#: rounded: bf16 the repo's 2e-2, a few ulps; measured 9.3e-3 in bf16,
#: 1.4e-7 in f32, measured on one H100)
EP_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
#: the aux loss rebuilt from all-reduced sums (route's me / ce): the one
#: place the sharded step may leave the unsharded step's bits
AUX_RTOL = 1e-6
PAR_CHILD_S = 300


def parallel_child(out: str) -> int:
    """Phase 53 (a), (c), (d) in a process of its own (``chip_smoke.py
    --parallel-child OUT``): a world-size-1 NCCL process group through a
    file rendezvous in ``OUT``, the (1, 1) ``(data, model)`` mesh, and
    Qwen3-30B-A3B at full width at 2 layers; the record is written to
    ``OUT/parallel.json``."""
    sys.path.insert(0, str(SRC))
    # two 2-layer training states take turns on the card: let freed blocks
    # be reused at other sizes (set before CUDA starts in this process)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{out}/rdzv", rank=0, world_size=1,
                            timeout=timedelta(seconds=120))
    try:
        rec = parallel_child_body(out, dev)
    finally:
        dist.destroy_process_group()
    Path(out, "parallel.json").write_text(json.dumps(rec))
    return 0


def parallel_child_body(out: str, dev) -> dict:
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.checkpoint.store import decode_leaf, encode_leaf, flatten_with_keys
    from repro_torch.configs import get
    from repro_torch.kernels.ckpt_codec import dequantize_blocks, quantize_blocks
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.launch.steps import (
        build_model, build_prefill_step, build_train_step, moment_shardings, param_shardings,
    )
    from repro_torch.models import RuntimeFlags
    from repro_torch.models.moe import EXPERT_LEAVES
    from repro_torch.optim import AdamWState, adamw_init, dp_allreduce_int8
    from repro_torch.optim.compress import _blockwise, _decode
    from repro_torch.parallel.sharding import (
        NamedSharding, PartitionSpec, local_block, shard_tree,
    )

    cfg = dataclasses.replace(get(QWEN3), num_layers=PAR_LAYERS)
    flags = RuntimeFlags()
    B, S = PAR_BATCH
    rng = np.random.default_rng(PAR_SEED)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)
               for _ in range(PAR_STEPS)]
    rec = {"layers": PAR_LAYERS, "of_layers": get(QWEN3).num_layers, "batch": list(PAR_BATCH),
           "steps": PAR_STEPS, "experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k}

    def fresh(model):
        g = torch.Generator(device=dev)
        g.manual_seed(PAR_SEED)
        return model.init(g)

    def run_steps(step, p, o, rows):
        metrics = []
        for b in batches:
            torch.cuda.synchronize()
            t = time.monotonic()
            p, o, m = step(p, o, {"tokens": rows(b)})
            metrics.append({k: float(v) for k, v in m.items()})  # syncs
            metrics[-1]["step_ms"] = (time.monotonic() - t) * 1e3
        return p, o, metrics

    # ---- (a) the unsharded step, then the sharded one ------------------ #
    t0 = time.monotonic()
    mu = build_model(cfg, flags)
    p = fresh(mu)
    p, o, met_u = run_steps(build_train_step(mu, lr=TRAIN_LR, total_steps=100), p,
                            adamw_init(p), lambda b: b)
    host = {k: v.cpu() for k, v in flatten_with_keys(p).items()}
    del p, o, mu
    torch.cuda.empty_cache()
    unsharded_s = time.monotonic() - t0

    t0 = time.monotonic()
    mesh = make_mesh_compat((1, 1), ("data", "model"), device=dev)
    ms = build_model(cfg, flags, mesh)
    p_sh, m_sh = param_shardings(ms), moment_shardings(ms, False)
    o_sh = AdamWState(NamedSharding(mesh, PartitionSpec()), m_sh)
    full = fresh(ms)
    p, o = shard_tree(full, p_sh), shard_tree(adamw_init(full), o_sh)
    del full
    rows_sh = NamedSharding(mesh, PartitionSpec("data"))
    torch.cuda.reset_peak_memory_stats(dev)
    p, o, met_s = run_steps(build_train_step(ms, lr=TRAIN_LR, total_steps=100), p, o,
                            lambda b: local_block(b, rows_sh))
    sharded_s = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    differ = [k for k, v in flatten_with_keys(p).items() if not torch.equal(v.cpu(), host[k])]
    aux_rel = max(abs(a["aux"] - b["aux"]) / max(abs(b["aux"]), 1e-30)
                  for a, b in zip(met_s, met_u))
    check(all(a[k] == b[k] for a, b in zip(met_s, met_u) for k in ("loss", "ce", "grad_norm")),
          f"sharded step losses {[m['loss'] for m in met_s]} differ from the unsharded "
          f"{[m['loss'] for m in met_u]}")
    check(aux_rel <= AUX_RTOL, f"sharded aux {aux_rel} (relative) from the unsharded")
    check(not differ, f"sharded step: parameters {differ[:4]} differ from the unsharded "
          "step's bits")
    check(all(np.isfinite(m["loss"]) for m in met_s), "non-finite loss")
    rec["step"] = {"unsharded": met_u, "sharded": met_s, "losses_bit_equal": True,
                   "params_bit_equal": True,
                   "aux_max_rel_diff": aux_rel, "aux_rtol": AUX_RTOL,
                   "aux_place": "route(): me / ce from the data group's all-reduced sums",
                   "unsharded_s": unsharded_s, "sharded_s": sharded_s,
                   "sharded_peak_bytes": peak, "leaves": len(host)}
    del host

    # the sharded prefill: one flash launch a layer, the unsharded bits
    flash_attention_bhsd.launches = flash_attention_bhsd.tc_launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    logits, _ = build_prefill_step(ms, S + 8)(p, {"tokens": local_block(batches[0], rows_sh)})
    torch.cuda.synchronize()
    prefill_s = time.monotonic() - t0
    fl, tc = flash_attention_bhsd.launches, flash_attention_bhsd.tc_launches
    want, _ = build_prefill_step(build_model(cfg, flags), S + 8)(p, {"tokens": batches[0]})
    check(fl == PAR_LAYERS and tc == PAR_LAYERS,
          f"sharded prefill: {fl} flash launches ({tc} tensor-core), {PAR_LAYERS} layers")
    check(bool(torch.isfinite(logits).all()), "sharded prefill: non-finite logits")
    same = bool(torch.equal(logits, want))
    check(same, "sharded prefill: logits differ from the unsharded prefill's bits")
    rec["prefill"] = {"seconds": prefill_s, "flash_launches": fl, "tc_launches": tc,
                      "bit_equal_to_unsharded": same, "logits_shape": list(logits.shape)}
    del logits, want

    # ---- (c) dp_allreduce_int8 at world size 1 ---------------------------- #
    g = torch.Generator(device=dev)
    g.manual_seed(PAR_SEED + 3)
    x = torch.randn(2**24 + 100, generator=g, device=dev)
    got = dp_allreduce_int8(x, mesh, "data")
    q, sc = _blockwise(x)
    ref = _decode(q, sc, x.numel(), x.shape)
    check(torch.equal(got.view(torch.int32), ref.view(torch.int32)),
          "dp_allreduce_int8 at world size 1 differs from the quantize -> dequantize trip")
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(5):
        dp_allreduce_int8(x, mesh, "data")
    b.record()
    torch.cuda.synchronize()
    rec["dp_allreduce_int8"] = {"elements": x.numel(), "bit_equal": True,
                                "ms": a.elapsed_time(b) / 5}
    del x, got, q, sc, ref

    # ---- (d) a ZeRO-1 state's save and sharded restore ------------------- #
    flat_p, flat_o = flatten_with_keys(p), flatten_with_keys(o.moments)
    flat_ps, flat_ms = flatten_with_keys(p_sh), flatten_with_keys(m_sh)
    tree, sh = {"params": {}, "opt": {}}, {"params": {}, "opt": {}}
    for n in EXPERT_LEAVES:
        k = f"blocks/0/mlp/{n}"
        tree["params"][n] = flat_p[k][0]  # layer 0 of the stack
        sh["params"][n] = NamedSharding(mesh, PartitionSpec(*tuple(flat_ps[k].spec)[1:]))
        tree["opt"][n], sh["opt"][n] = {}, {}
        for mom in ("m", "v"):
            tree["opt"][n][mom] = flat_o[f"{k}/{mom}"][0]
            sh["opt"][n][mom] = NamedSharding(
                mesh, PartitionSpec(*tuple(flat_ms[f"{k}/{mom}"].spec)[1:]))
    del p, o, flat_p, flat_o
    torch.cuda.empty_cache()
    store = CheckpointStore(str(Path(out, "zero1")), codec="int8")
    quantize_blocks.launches = dequantize_blocks.launches = 0
    res = store.save(1, tree, shardings=sh)
    q_launches = quantize_blocks.launches
    restored = store.restore(1, device=dev, shardings=sh)
    dq_launches = dequantize_blocks.launches
    n_bad, nbytes = 0, 0
    for k, x in flatten_with_keys(tree).items():
        payload, meta = encode_leaf(x)
        trip = decode_leaf(payload, meta, None, dev)
        n_bad += int(not torch.equal(restored[k].view(torch.int32), trip.view(torch.int32)))
        nbytes += x.numel() * x.element_size()
    check(n_bad == 0, f"ZeRO-1 restore: {n_bad} leaves differ from the coded round trip")
    n_leaves = len(flatten_with_keys(tree))
    check(q_launches == n_leaves and dq_launches == n_leaves,
          f"ZeRO-1 save / restore: {q_launches} / {dq_launches} codec launches, {n_leaves} leaves")
    rec["zero1_ckpt"] = {"leaves": n_leaves, "raw_bytes": nbytes,
                         "stored_bytes": res["stored_bytes"], "c_block": res["t_snapshot"],
                         "c_full": res["t_total"], "quantize_launches": q_launches,
                         "dequantize_launches": dq_launches, "bit_equal_to_round_trip": True}
    return rec


def ep_shares(dev) -> dict:
    """Phase 53 (b): one MoE layer of Qwen3-30B-A3B at full width (128
    experts, top-8, the config's capacity factor) on 8 x 1024 tokens, its
    output as PAR_EP_M expert-parallel shares run in turn (no process
    group) and summed in rank order, against ``moe_apply``; the device ms
    of each share beside moe_apply's."""
    import dataclasses

    import torch
    from repro_torch.configs import get
    from repro_torch.models.moe import init_moe, moe_apply, moe_expert_share, route

    cfg = dataclasses.replace(get(QWEN3), num_layers=1)
    E, D = cfg.moe.num_experts, cfg.d_model
    n = E // PAR_EP_M
    g = torch.Generator(device=dev)
    g.manual_seed(PAR_SEED + 1)
    p32 = init_moe(g, cfg, torch.float32)
    x32 = torch.randn(PAR_BATCH + (D,), generator=g, device=dev)
    out = {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        p = {k: v if k == "router" else v.to(dt) for k, v in p32.items()}
        x = x32.to(dt)
        xt = x.reshape(-1, D)
        r = route(p, xt, cfg)
        r2 = route(p, xt, cfg)
        same = bool(torch.equal(r.expert_ids, r2.expert_ids) and torch.equal(r.keep, r2.keep))
        check(same, f"EP shares, {name}: the routing changed between two calls")
        want, _ = moe_apply(p, x, cfg)
        slices = [{k: p[k][m * n:(m + 1) * n] for k in ("wi_gate", "wi_up", "wo")}
                  for m in range(PAR_EP_M)]
        shares = [moe_expert_share(xt, r, s["wi_gate"], s["wi_up"], s["wo"], m, PAR_EP_M)
                  for m, s in enumerate(slices)]
        y = shares[0]
        for s in shares[1:]:
            y = y + s
        err = float((y.float() - want.reshape(-1, D).float()).abs().max())
        scale = float(want.float().abs().max())
        check(err <= EP_TOL[name] * scale,
              f"EP shares, {name}: {err} from moe_apply (max|y| {scale})")
        share_ms = [device_ms([lambda m=m, s=s: moe_expert_share(
            xt, r, s["wi_gate"], s["wi_up"], s["wo"], m, PAR_EP_M)], samples=5)[0]
            for m, s in enumerate(slices)]
        apply_ms = device_ms([lambda: moe_apply(p, x, cfg)], samples=5)[0]
        out[name] = {"experts_per_rank": n, "max_abs_diff": err, "max_abs_y": scale, "tol_of_max": EP_TOL[name],
                     "routing_equal": same, "dropped_pairs": int((~r.keep).sum()),
                     "capacity": r.capacity, "share_ms": share_ms,
                     "shares_ms_sum": sum(share_ms), "moe_apply_ms": apply_ms}
        del p, x, xt, r, r2, want, shares, y, slices
    del p32, x32
    torch.cuda.empty_cache()
    return out


def parallel_phases(dev, kernels: list) -> None:
    """Phase 53: the distributed layer on the card.  (a) Qwen3-30B-A3B at
    full width (128 experts, top-8) at 2 of its 48 layers: the sharded
    train step (ZeRO-1 specs, f32 AdamW) at world size 1 over NCCL, two
    steps of 8 x 1024 tokens, bit-equal to the unsharded step, and a
    sharded prefill (one flash launch a layer); (b) one MoE layer's
    expert-parallel shares, m = 0..7 of 8, run in turn against
    ``moe_apply``; (c) ``dp_allreduce_int8`` at world size 1 over NCCL; (d)
    a ZeRO-1 state of one MoE layer's expert leaves and their moments
    saved through the int8 store and restored with ``shardings=``.  (a),
    (c) and (d) run in a subprocess with its own process group.  Adds the
    path's launches to the flash and codec entries of ``kernels``."""
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--parallel-child",
                               tmp], capture_output=True, text=True, timeout=PAR_CHILD_S)
        check(proc.returncode == 0, f"phase 53 child exited {proc.returncode}:\n"
              f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        rec = json.loads(Path(tmp, "parallel.json").read_text())
    smi = smi_line()
    emit("parallel_step", seconds=time.monotonic() - t0, world_size=1, backend="nccl",
         mesh={"data": 1, "model": 1}, **{k: rec[k] for k in (
             "layers", "of_layers", "batch", "steps", "experts", "top_k", "step", "prefill")},
         nvidia_smi=smi)
    emit("parallel_dp_allreduce_int8", **rec["dp_allreduce_int8"], nvidia_smi=smi)
    emit("parallel_zero1_ckpt", **rec["zero1_ckpt"], nvidia_smi=smi)
    t1 = time.monotonic()
    shares = ep_shares(dev)
    emit("parallel_ep_shares", seconds=time.monotonic() - t1, ranks=PAR_EP_M,
         tokens=PAR_BATCH[0] * PAR_BATCH[1],
         results=shares, nvidia_smi=smi)
    paths = {"flash_attention_bhsd": rec["prefill"]["flash_launches"],
             "quantize_blocks": rec["zero1_ckpt"]["quantize_launches"],
             "dequantize_blocks": rec["zero1_ckpt"]["dequantize_launches"]}
    for k in kernels:
        if k["name"] in paths:
            k["parallel_path_launches"] = paths[k["name"]]
    emit("parallel_phases", seconds=time.monotonic() - t0)


def main() -> int:
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--campaign-fault"]:
        return campaign_fault_child(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--parallel-child"]:
        return parallel_child(sys.argv[2])
    # "--only train" / "--only families" / "--only hybrid" / "--only
    # ssm_train" / "--only parallel": the environment, the build and phases
    # 38-40 / 41-44 / 45-48 / 49-52 / 53 alone
    only = sys.argv[2] if sys.argv[1:2] == ["--only"] and len(sys.argv) > 2 else None
    if only not in (None, "train", "families", "hybrid", "ssm_train", "parallel"):
        print("chip_smoke: --only takes train, families, hybrid, ssm_train or parallel, "
              f"not {only!r}", file=sys.stderr)
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
    scan_regs = ptxas_kernels(logs.get("mamba_scan", ""), r"(scan_(?:prefill|decode)_kernel)")
    bwd_regs = {**ptxas_kernels(logs.get("rwkv6_bwd", ""), r"(wkv6_bwd_\w+_kernel)"),
                **ptxas_kernels(logs.get("mamba_scan_bwd", ""), r"(scan_bwd_\w+_kernel)")}
    emit("build", seconds=time.monotonic() - t0, built=sorted(logs),
         ptxas=ptxas, sim_step_registers=regs, wkv6_registers=wkv_regs,
         selective_scan_registers=scan_regs, backward_registers=bwd_regs)

    from repro_torch.kernels import sim_step as K

    if only == "train":
        train_phases(dev, [])
        emit("total", seconds=time.monotonic() - t_script)
        return 0
    if only == "families":
        family_phases(dev, [])
        emit("total", seconds=time.monotonic() - t_script)
        return 0
    if only == "hybrid":
        hybrid_phases(dev, [], scan_regs)
        emit("total", seconds=time.monotonic() - t_script)
        return 0
    if only == "ssm_train":
        ssm_train_phases(dev, [], bwd_regs)
        emit("total", seconds=time.monotonic() - t_script)
        return 0
    if only == "parallel":
        parallel_phases(dev, [])
        emit("total", seconds=time.monotonic() - t_script)
        return 0

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
    t0 = time.monotonic()
    campaign_phases(dev, res, wall)
    emit("campaign_phases", seconds=time.monotonic() - t0)
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    train_phases(dev, kernels)
    emit("train_phases", seconds=time.monotonic() - t0)
    torch.cuda.empty_cache()  # Qwen3-30B-A3B's 61 GB of weights need the card
    t0 = time.monotonic()
    family_phases(dev, kernels)
    emit("family_phases", seconds=time.monotonic() - t0)
    torch.cuda.empty_cache()  # Jamba's 51.8 GB of weights need the card
    t0 = time.monotonic()
    hybrid_phases(dev, kernels, scan_regs)
    emit("hybrid_phases", seconds=time.monotonic() - t0)
    torch.cuda.empty_cache()  # the training cuts need the card's memory
    t0 = time.monotonic()
    ssm_train_phases(dev, kernels, bwd_regs)
    emit("ssm_train_phases", seconds=time.monotonic() - t0)
    torch.cuda.empty_cache()  # phase 53's child process needs the card's memory
    parallel_phases(dev, kernels)
    emit("total", seconds=time.monotonic() - t_script)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
