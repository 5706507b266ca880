"""A/B timing of the RWKV6-7B serving path for two checkouts of the port.

    python3 tools/rwkv_ab.py A_ROOT B_ROOT [--order abba]

For each letter of ``--order`` (``a``: A_ROOT, ``b``: B_ROOT), one process
with that checkout's ``src`` on the path and its kernels built from that
checkout's sources builds RWKV6-7B at full width and depth in bf16
(random weights from a ``torch.Generator`` seeded 0, as ``chip_smoke.py``
phase 17 does) and times, on 8 prompts of 1024 tokens from
``np.random.default_rng(0)``:

* the prefill (host clock around the call and a synchronize, median of 3
  after a warm-up);
* one decode step replayed as a CUDA graph (device time, median of 20
  replays) and issued eagerly (CUDA events around 20 calls);
* the WKV kernel alone, at phase 18's shapes: one prefill launch (zero
  initial state) and one decode step's 32 launches, each on its own
  layer's state, in a CUDA graph.

Needs one CUDA card and ``chip_smoke.py`` beside ``tools/`` (its timing
helpers).  Prints the card's name and power limit, then one JSON line a
run.  Unpack the other checkout with ``git archive`` into a directory
that ``.gitignore`` lists (e.g. ``build/ab_parent``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REQUESTS, PROMPT_LEN, SEED = 8, 1024, 0


def run(root: str) -> None:
    """One checkout's timings (this process's ``src`` is ``root``'s)."""
    import numpy as np
    import torch

    sys.path.insert(1, str(ROOT))  # chip_smoke's helpers
    import chip_smoke as CS
    from repro_torch.configs import get
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import rwkv6 as W
    from repro_torch.models import LanguageModel

    build.load("rwkv6")
    dev = torch.device("cuda", 0)
    cfg = get("rwkv6-7b")
    L, H, hd = cfg.num_layers, cfg.rwkv_heads, cfg.ssm.rwkv_head_dim
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    m = LanguageModel(cfg)
    params = m.cast_params(m.init(g))
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (REQUESTS, PROMPT_LEN)).astype(np.int32)).to(dev)
    max_seq = PROMPT_LEN + 136
    logits, cache = m.prefill(params, prompts, max_seq)  # warm-up
    prefill_s = []
    for _ in range(3):
        del logits, cache
        torch.cuda.synchronize()
        t0 = time.monotonic()
        logits, cache = m.prefill(params, prompts, max_seq)
        torch.cuda.synchronize()
        prefill_s.append(time.monotonic() - t0)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    step_graph, _ = CS.device_ms([lambda: m.decode_step(params, cache, tok)], samples=20)
    step_eager = CS.eager_ms(lambda: m.decode_step(params, cache, tok), 20)
    del params, cache, logits, m
    torch.cuda.empty_cache()

    r, k, v, w, u = W.sample_wkv_inputs(REQUESTS, PROMPT_LEN, H, hd, seed=40, device=dev)[:5]
    wkv_prefill, _ = CS.device_ms([lambda: ops.wkv6(r, k, v, w, u)])
    del r, k, v, w
    layers = [W.sample_wkv_inputs(REQUESTS, 1, H, hd, seed=50 + i, device=dev)
              for i in range(L)]
    outs = [torch.empty_like(x[5]) for x in layers]
    wkv_decode, _ = CS.device_ms([lambda x=x, o=o: ops.wkv6(*x, state_out=o)
                                  for x, o in zip(layers, outs)])
    print(json.dumps({
        "root": root, "prefill_s": statistics.median(prefill_s), "prefill_s_all": prefill_s,
        "decode_step_graph_ms": step_graph, "decode_step_eager_ms": step_eager,
        "wkv_prefill_ms": wkv_prefill, "wkv_decode_ms": wkv_decode,
    }), flush=True)


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
        print("rwkv_ab: no CUDA device", file=sys.stderr)
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
