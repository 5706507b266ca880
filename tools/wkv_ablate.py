"""Where the WKV prefill kernel's time goes, on one CUDA card.

Two parts, both built with the port's nvcc flags into
``build/repro_torch/ablate/``:

* Calibration of the SM's pipes, each kernel on 132 x 4 blocks of 128
  threads: the exact state update (fl(w S) + fl(k v), 32 entries a
  thread) from registers alone, as f32 issue efficiency; then shared
  loads of several address patterns and warp shuffles, in cycles a warp
  instruction takes the SM (at the SM clock read before the run).
* Ablations of ``src/repro_torch/kernels/csrc/rwkv6.cu``: copies of the
  source with one part of the prefill kernel taken out (the staging after
  the first chunk, the bonus dots, the y pass), each built and timed
  like ``chip_smoke.py`` phase 18 times the shipped kernel: one launch at
  the serving path's prefill shape (8 x 1024 tokens x 64 heads x 64, zero
  initial state) in a CUDA graph, the median of replays.  The ablated
  kernels compute wrong results by design; the source as built is held to
  the plain version.  Each cut must match the source exactly once.

    python3 tools/wkv_ablate.py

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

B, S, H, HD = 8, 1024, 64, 64
CAL_BLOCKS, CAL_ITERS = 132 * 4, 4096

#: (name, text of rwkv6.cu, its replacement)
CUTS = (
    ("no_staging_after_first_chunk",
     "    if (t0 + CH < a.S) stage(t0 + CH, c ^ 1);", "    c = 0;"),
    ("no_bonus_dots",
     "    for (int tb = 0; tb < CH; tb += NT / P) {", "    for (int tb = 0; tb < 0; tb += NT / P) {"),
    ("no_y_pass",
     "      if (((CH * Q) % NT == 0 || e < CH * Q) && t < n) {\n        float4 s4",
     "      if (((CH * Q) % NT == 0 || e < CH * Q) && t < n && t0 == 0) {\n        float4 s4"),
)

CALIBRATION = r"""
#include <cuda_runtime.h>
// MODE 0: the exact state update of 8 x 4 entries from registers; 1-6:
// eight shared loads an iteration of a pattern; 7: eight shuffles
template <int MODE>
__global__ void __launch_bounds__(128, 4) cal(float* out, int iters) {
  __shared__ __align__(16) float buf[4096];
  const int tid = threadIdx.x, lane = tid & 31;
  for (int e = tid; e < 4096; e += 128) buf[e] = 1e-3f * (e % 89);
  __syncthreads();
  const int off = MODE == 1 ? 0 : MODE == 2 ? 4 * (lane / 8) : MODE == 3 ? 4 * (lane % 8)
                : MODE == 4 ? 4 * lane : MODE == 5 ? 0 : lane;
  float st[8][4], w[8], k[8], v[4];
  for (int i = 0; i < 8; ++i) {
    w[i] = 0.9f + 1e-3f * i + 1e-6f * tid; k[i] = 0.1f * i;
    for (int q = 0; q < 4; ++q) st[i][q] = 1e-3f * (i + q);
  }
  for (int q = 0; q < 4; ++q) v[q] = 0.3f + q;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float s = lane;
#pragma unroll 1
  for (int t = 0; t < iters; ++t) {
    if (MODE == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = __fmul_rn(v[q], 0.999f);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          st[i][q] = __fadd_rn(__fmul_rn(w[i], st[i][q]), __fmul_rn(k[i], v[q]));
    } else {
      const int base = (t & 7) * 256;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (MODE == 7) {
          s += __shfl_xor_sync(0xffffffffu, s, 1 << (u % 5));
        } else if (MODE >= 5) {
          acc.x += buf[base + 32 * u + off];
        } else {
          const float4 q = *reinterpret_cast<const float4*>(&buf[base + 32 * u + off]);
          acc.x += q.x; acc.y += q.y; acc.z += q.z; acc.w += q.w;
        }
      }
    }
  }
  for (int i = 0; i < 8; ++i)
    for (int q = 0; q < 4; ++q) s += st[i][q];
  out[blockIdx.x * 128 + tid] = acc.x + acc.y + acc.z + acc.w + s;
}
extern "C" int cal_run(int mode, void* out, int iters, int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (mode) {
    case 0: cal<0><<<blocks, 128, 0, st>>>(o, iters); break;
    case 1: cal<1><<<blocks, 128, 0, st>>>(o, iters); break;
    case 2: cal<2><<<blocks, 128, 0, st>>>(o, iters); break;
    case 3: cal<3><<<blocks, 128, 0, st>>>(o, iters); break;
    case 4: cal<4><<<blocks, 128, 0, st>>>(o, iters); break;
    case 5: cal<5><<<blocks, 128, 0, st>>>(o, iters); break;
    case 6: cal<6><<<blocks, 128, 0, st>>>(o, iters); break;
    case 7: cal<7><<<blocks, 128, 0, st>>>(o, iters); break;
  }
  return static_cast<int>(cudaGetLastError());
}
"""
CAL_MODES = ("f32_state_update", "lds128_one_address", "lds128_one_address_a_quarter",
             "lds128_8_addresses_a_quarter", "lds128_32_addresses", "lds32_one_address",
             "lds32_32_addresses", "shfl")


def build_all(out_dir: Path) -> dict:
    """Every library, by parallel ``nvcc`` runs: the calibration and one
    copy of rwkv6.cu a cut (and the source as built)."""
    from repro_torch.kernels import build

    src = (build.CSRC / "rwkv6.cu").read_text()
    sources = {"calibration": CALIBRATION, "as_built": src}
    for name, needle, repl in CUTS:
        if src.count(needle) != 1:
            raise RuntimeError(f"rwkv6.cu has no single {needle!r} (cut {name})")
        sources[name] = src.replace(needle, repl)
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (out_dir / f"{name}.cu").write_text(text)
        lib = out_dir / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        if name == "calibration":
            cdll.cal_run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
        else:
            cdll.wkv6_fwd.argtypes = build._SIGNATURES["rwkv6"]["wkv6_fwd"]
        libs[name] = cdll
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("wkv_ablate: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from repro_torch.kernels import build
    from repro_torch.kernels import rwkv6 as W

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build_all(build.BUILD_DIR / "ablate")
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    mhz = int(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, check=True).stdout.split()[0])

    cal, out = {}, torch.empty(CAL_BLOCKS * 128, device=dev)
    for mode, name in enumerate(CAL_MODES):
        run = lambda: libs["calibration"].cal_run(mode, out.data_ptr(), CAL_ITERS, CAL_BLOCKS,
                                                  stream)
        for _ in range(3):
            run()
        ms = CS.eager_ms(run, 10)
        warps_per_sm = 4 * 128 // 32
        cycles = ms * 1e-3 * mhz * 1e6
        if mode == 0:  # 96 f32 instructions an iteration and 4 for v, one issue a cycle a partition
            ideal = warps_per_sm / 4 * CAL_ITERS * 100
            cal[name] = {"ms": ms, "issue_efficiency": ideal / cycles}
        else:
            cal[name] = {"ms": ms, "cycles_per_warp_instruction": cycles /
                         (warps_per_sm * CAL_ITERS * 8)}

    r, k, v, w, u = W.sample_wkv_inputs(B, S, H, HD, seed=40, device=dev)[:5]
    want = W.wkv_ref(r, k, v, w, u)
    u3 = u.unsqueeze(0).expand(B, H, HD)
    times = {}
    for name, lib in libs.items():
        if name == "calibration":
            continue
        y = torch.empty_like(r)
        sT = torch.empty((B, H, HD, HD), device=dev)

        def call(lib=lib, y=y, sT=sT):
            bsh = [s_ for x in (r, k, v, w) for s_ in x.stride()[:3]]
            rc = lib.wkv6_fwd(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                              u3.data_ptr(), None, y.data_ptr(), sT.data_ptr(), B, S, H, HD,
                              *bsh, u3.stride(0), u3.stride(1), 0, 0, 0,
                              *y.stride()[:3], *sT.stride()[:3],
                              torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{name}: launch returned {rc}")
            return y, sT

        ms, got = CS.device_ms([call], samples=20)
        if name == "as_built":
            CS.wkv_close(got, want, "wkv_ablate: the source as built")
        times[name] = ms
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "sm_clock_max_mhz": mhz, "calibration": cal,
                      "prefill_ms": times, "shape": [B, S, H, HD],
                      "note": "calibration: 132 x 4 blocks of 128 threads, 4096 iterations; "
                              "cycles at the card's maximum SM clock; prefill_ms: device_ms "
                              "(CUDA graph, median of 20 replays); ablated kernels compute "
                              "wrong results by design"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
