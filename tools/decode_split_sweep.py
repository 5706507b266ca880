"""Time the decode attention kernels at 32, 64 and 128 cache rows a split.

The split size is a compile-time constant of
``src/repro_torch/kernels/csrc/decode_attention.cu`` (``kSplitRows``).
This script builds the source three times, once for each split size,
into ``build/repro_torch/sweep/``, and times each build on the serving
path's decode shape (SmolLM-135M, batch 8: q ``(8, 1, 9, 64)`` over the
30 layers' bf16 caches ``(8, 1160, 3, 64)`` at pos 1087), the way
``chip_smoke.py`` phase 14 times the shipped kernel: the 30 calls in one
CUDA graph, the median of 10 replays.  Every build's output is held to
the plain version within the bf16 tolerance 2e-2.  Needs one CUDA card:

    python3 tools/decode_split_sweep.py

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

ROWS = (32, 64, 128)
B, MAX_SEQ, H, KV, HD, LAYERS = 8, 1160, 9, 3, 64, 30
POS = 1024 + 128 // 2 - 1
TOL = 2e-2


def build_variants() -> dict:
    """One library per split size, built by parallel ``nvcc`` runs from
    copies of the source that differ in ``kSplitRows`` alone."""
    from repro_torch.kernels import build

    src = (build.CSRC / "decode_attention.cu").read_text()
    line = "constexpr int kSplitRows = 128;"
    if src.count(line) != 1:
        raise RuntimeError(f"decode_attention.cu has no single line {line!r}")
    out_dir = build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for r in ROWS:
        cu = out_dir / f"decode_attention_r{r}.cu"
        cu.write_text(src.replace(line, f"constexpr int kSplitRows = {r};"))
        lib = out_dir / f"libdecode_attention_r{r}.so"
        procs[r] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for r, (lib, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {r} rows a split:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        fn = cdll.decode_attention_fwd
        fn.argtypes = build._SIGNATURES["decode_attention"]["decode_attention_fwd"]
        fn.restype = ctypes.c_int
        libs[r] = fn
    return libs


def call(fn, rows, q, k, v, pos):
    """Decode attention in the model layout through one build's entry."""
    import torch
    from repro_torch.kernels.flash_attention import _DTYPE_CODE
    from repro_torch.kernels.sim_step import _raise_on, _stream_ptr

    q3, o = q[:, 0], torch.empty_like(q)
    o3 = o[:, 0]
    part = torch.empty(B * H * -(-MAX_SEQ // rows) * (HD + 2), dtype=torch.float32,
                       device=q.device)
    rc = fn(q3.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), part.data_ptr(),
            o3.data_ptr(), _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype], B, H, KV, MAX_SEQ, HD,
            1, q3.stride(0), q3.stride(1), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), o3.stride(0), o3.stride(1),
            _stream_ptr(q.device))
    _raise_on(f"decode_attention ({rows} rows a split)", rc)
    return o


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("decode_split_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import device_ms
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    libs = build_variants()
    g = torch.Generator(device=dev)
    g.manual_seed(30)
    layers = [tuple(torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                    for shape in ((B, 1, H, HD), (B, MAX_SEQ, KV, HD), (B, MAX_SEQ, KV, HD)))
              for _ in range(LAYERS)]
    p = torch.tensor(POS, dtype=torch.int32, device=dev)
    want = DA.attention_ref(layers[0][0][:, 0], layers[0][1], layers[0][2], p).unsqueeze(1)
    ms = {}
    for r, fn in libs.items():
        ms[r], out = device_ms([lambda x=x, fn=fn, r=r: call(fn, r, *x, p) for x in layers])
        torch.testing.assert_close(out, want, atol=TOL, rtol=TOL)
    shipped, out = device_ms([lambda x=x: ops.decode_attention(*x, p) for x in layers])
    torch.testing.assert_close(out, want, atol=TOL, rtol=TOL)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(json.dumps({"ms_by_split_rows": ms, "shipped_split_rows": DA.SPLIT_ROWS,
                      "shipped_ms": shipped, "pos": POS,
                      "shape": f"q ({B}, 1, {H}, {HD}), cache ({B}, {MAX_SEQ}, {KV}, {HD}) bf16"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
