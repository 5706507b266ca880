"""Batched server with fault-tolerant decode (the port of the
reference's ``launch/serve.py``).

Prefill, then a greedy decode loop over a batch of requests.  The server
snapshots the decode cache (the KV cache, or the RWKV states and last
tokens) every ``snapshot_every`` tokens; a fault (from a
wall-clock fault trace) restores the last snapshot and re-decodes the
tokens generated since.  Serving "waste" is the re-decoded tokens plus
the snapshot time.

A frontend family (musicgen, llava-next) is served with the reference's
stub frontend: precomputed embeddings ``(requests, prefix, d_model)``
drawn after the prompts, prepended to every prompt.

The cache is updated in place, so a snapshot is a copy of it (into
buffers cloned once) and a restore copies the snapshot back: an alias
would let a replay decode from a cache that has already moved on.
``pos`` stays a 0-d int32 tensor on the device; the loop never reads it.

Usage (on the card; ``--device cpu`` runs the kernels' plain versions):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --requests 4 --prompt-len 32 --gen 48 --inject-faults
(``--arch`` takes any registered architecture, every one of the
reference's; the CLI serves its ``reduced()`` config.)
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .. import configs
from ..configs.base import ArchConfig
from ..core.events import make_event_trace
from ..core.torch_sim import resolve_device
from .steps import build_decode_step, build_model, build_prefill_step

__all__ = ["serve", "draw_requests", "fault_trace", "main"]


def fault_trace(seed: int, mtbf: float, horizon: float = 600.0) -> list:
    """Wall-clock fault times (s) of the reference's server: exponential
    faults of mean ``mtbf`` over ``horizon``, none predicted."""
    tr = make_event_trace(np.random.default_rng(seed + 3), horizon=horizon, mtbf=mtbf,
                          recall=0.0, precision=1.0)
    return [f.time for f in tr.faults]


def draw_requests(cfg: ArchConfig, requests: int, prompt_len: int, seed: int) -> dict:
    """The prefill batch of :func:`serve`, on the CPU, drawn from
    ``np.random.default_rng(seed)`` as the reference's server draws it:
    ``tokens`` ``(requests, prompt_len)`` int32 and, for a frontend family,
    then ``frontend``, ``0.02 N(0, 1)`` of shape ``(requests, prefix,
    d_model)`` in bf16 (torch rounds f64 -> f32 -> bf16, as
    ``jnp.asarray(..., jnp.bfloat16)`` does)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (requests, prompt_len)).astype(np.int32))}
    if cfg.frontend:
        batch["frontend"] = torch.from_numpy(
            rng.standard_normal((requests, cfg.frontend_prefix, cfg.d_model)) * 0.02
        ).to(torch.bfloat16)
    return batch


def _copy_cache(dst: dict, src: dict) -> None:
    dst["pos"].copy_(src["pos"])
    for d, s in zip(dst["blocks"], src["blocks"]):
        for k in d:
            d[k].copy_(s[k])


def _clone_cache(cache: dict) -> dict:
    return {"pos": cache["pos"].clone(),
            "blocks": tuple({k: v.clone() for k, v in b.items()} for b in cache["blocks"])}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg: ArchConfig, *, requests: int, prompt_len: int, gen: int,
          snapshot_every: int = 16, fault_times: Sequence[float] = (), seed: int = 0,
          device=None) -> dict:
    """Serve ``requests`` prompts of ``prompt_len`` tokens (drawn from
    ``np.random.default_rng(seed)`` as the reference draws them; for a
    frontend family, then the frontend embeddings, ``0.02 N(0, 1)`` of
    shape ``(requests, prefix, d_model)`` rounded to bf16) and generate
    ``gen`` tokens each, greedily, on ``device`` (the current
    CUDA device by default; without CUDA and without ``device`` it raises
    before building the model).  Weights come from a ``torch.Generator`` seeded with
    ``seed`` on that device.  A fault at wall time
    ``fault_times[i]`` (s from the start of prefill) restores the last
    snapshot.

    Returns ``tokens`` (``(requests, gen)`` int32, on the CPU), ``faults``,
    ``redecoded`` (tokens decoded again after a restore), ``decode_steps``
    (all decode steps run), ``prefill_s``, ``decode_s`` and ``wall_s``."""
    dev = resolve_device(device)
    model = build_model(cfg)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    params = model.cast_params(model.init(g))  # once, not on every step
    max_seq = prompt_len + cfg.frontend_prefix + gen + 8
    batch = {k: v.to(dev) for k, v in draw_requests(cfg, requests, prompt_len, seed).items()}
    prefill = build_prefill_step(model, max_seq)
    decode = build_decode_step(model)

    _sync(dev)
    t_start = time.monotonic()
    logits, cache = prefill(params, batch)
    out_tokens = [torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]]
    snapshot, k_snap = _clone_cache(cache), 1
    _sync(dev)
    prefill_s = time.monotonic() - t_start

    fi = n_faults = redecoded = steps = 0
    k = 1
    while k < gen:
        now = time.monotonic() - t_start
        if fi < len(fault_times) and fault_times[fi] <= now:
            fi += 1
            n_faults += 1
            _copy_cache(cache, snapshot)  # restore, then replay from k_snap
            redecoded += k - k_snap
            out_tokens = out_tokens[:k_snap]
            k = k_snap
            continue
        logits, cache = decode(params, cache, out_tokens[-1])
        out_tokens.append(torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None])
        k += 1
        steps += 1
        if k % snapshot_every == 0:
            _copy_cache(snapshot, cache)
            k_snap = k
    tokens = torch.cat(out_tokens, dim=1).cpu()
    wall = time.monotonic() - t_start
    return {"tokens": tokens, "faults": n_faults, "redecoded": redecoded,
            "decode_steps": steps, "prefill_s": prefill_s,
            "decode_s": wall - prefill_s, "wall_s": wall}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m", choices=configs.ARCH_NAMES)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=48)
    ap.add_argument("--snapshot-every", type=int, default=16, help="tokens")
    ap.add_argument("--inject-faults", action="store_true")
    ap.add_argument("--fault-mtbf", type=float, default=4.0, help="seconds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch).reduced()
    faults = fault_trace(args.seed, args.fault_mtbf) if args.inject_faults else []
    res = serve(cfg, requests=args.requests, prompt_len=args.prompt_len, gen=args.gen,
                snapshot_every=args.snapshot_every, fault_times=faults, seed=args.seed,
                device=args.device)
    toks, dt = res["tokens"], res["wall_s"]
    print(f"generated {tuple(toks.shape)} tokens in {dt:.1f}s "
          f"({args.requests * args.gen / dt:.1f} tok/s), faults={res['faults']}, "
          f"re-decoded={res['redecoded']} tokens")
    print("sample:", toks[0][:16].numpy())
    return res


if __name__ == "__main__":
    main()
