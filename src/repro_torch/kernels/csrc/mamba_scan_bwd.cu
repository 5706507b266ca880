// Hand-written Hopper (sm_90a) backward of Mamba's selective scan.
//
// selective_scan_bwd replaces no TPU kernel.  The reference computes the
// scan in src/repro/models/ssm.py::_ssm_scan as a lax.scan and trains
// through jax.grad of it; the port runs the forward as csrc/mamba_scan.cu
// and its reverse as the three kernels of this file, the backward of
// repro_torch/kernels/mamba.py's autograd Function (plain version:
// mamba.py::selective_scan_bwd_ref).
//
// Per (batch b, channel d), with the state h[0..ds) (f32), token t:
//   da_t[s] = exp(dt_t A[d, s]),   u_t = dt_t x_t
//   h_t[s]  = da_t[s] h_{t-1}[s] + u_t B_t[s]
//   y_t     = sum_s h_t[s] C_t[s]
// Given dy (and dh_T, or zeros), Gc_t = da_{t+1} G_{t+1} (Gc = dh_T after the
// last token) runs in reverse, with G_t = C_t dy_t + Gc_t, and
//   dC_t[s] = sum_d dy_t h_t[s]            dB_t[s] = sum_d G_t[s] u_t
//   du_t    = sum_s G_t[s] B_t[s]           dx_t = du_t dt_t
//   gz_t[s] = G_t[s] h_{t-1}[s] da_t[s]     (the gradient of dt_t A[s])
//   ddt_t   = du_t x_t + sum_s gz_t[s] A[s]
//   dA[d,s] = sum_{b,t} gz_t[s] dt_t
//   dh0     = Gc before the first token.
//
// The recurrence is never inverted: exp(dt A) underflows (A reaches -16 at
// ds 16), so h_{t-1} is not (h_t - u B)/da.  The states are recomputed:
//   1. scan_bwd_states_kernel runs the forward recurrence and stores the
//      state at the start of every chunk of kChunk tokens in scratch.
//   2. scan_bwd_reverse_kernel walks the chunks from the last: it reloads a
//      chunk's start state, recomputes the chunk's kChunk states into
//      registers, then runs G backwards over them, writing ddt and dx, a
//      per-block partial of dB and dC for every token (each warp's 32
//      channels folded by a fixed shuffle tree, the block's 4 warps added
//      in order), dh0 and per-batch-row partials of dA.
//   3. scan_bwd_reduce_kernel adds the partials in a fixed order: dB and dC
//      over the channel blocks, dA over the batch.  No atomics anywhere, so
//      two runs give the same bits.
//
// Numerics.  Built with --fmad=false, every product and sum rounded alone
// (__fmul_rn / __fadd_rn) and expf libdevice's, as the plain version rounds
// them (and as csrc/mamba_scan.cu does): the recomputed states are the
// forward's bits, and the elementwise G (hence dh0) is the plain version's
// bit for bit.  The reductions (over s for ddt, over d for dB / dC, over b
// and t for dA) take other orders than the plain version's and are held to
// it within a tolerance.
//
// Layout.  dt, x, dy, ddt, dx (batch, seq, d); B, C, dB, dC (batch, seq,
// ds); A, dA (d, ds); h0, dhT, dh0 (batch, d, ds); all contiguous f32.  h0
// and dhT may be null (zeros), dh0 null (not wanted).
//
// Design.  One thread owns one (b, d) channel, as in the forward; a block
// of kThreads channels of one batch row.  A thread keeps its chunk's
// kChunk + 1 states (the start and each token's) in registers, its dt, x,
// dy and A in shared memory, B and C rows staged for the block.
//
// What bounds it on an H100 (Jamba-1.5-Large training: B 8, S 1024, d
// 16384, ds 16): reading dt, x, dy and writing ddt, dx moves 5 x 537 MB,
// 0.80 ms at 3.35 TB/s; the 2.15e9 state entries take ~20 f32 operations a
// token each (the state recomputed with its exp, G, the four products of
// dB, dC, du, gz, dA and the carried G), 0.64 ms at 67 TFLOP/s.  This first
// kernel also writes and reads the chunk start states (1.07 GB at kChunk 8)
// and the dB / dC partials (537 MB); PERF.md has its times.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // channels of one batch row a block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;      // tokens a chunk
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float *dt, *x, *A, *Bc, *Cc, *h0, *dy, *dhT;
  float *ddt, *dx, *dA, *dB, *dC, *dh0;
  float *states, *bc_part, *dA_part;
  int B, S, D;
};

// Fold N values a lane over the warp: at each xor offset O (16, 8, ... 1)
// a lane keeps one half of its values and adds its partner's copy of that
// half, so the lane ends holding one value index's warp sum, index lane >>
// log2(32 / N).  A fixed tree: the same bits every run.
template <int N, int O>
struct Fold {
  static __device__ __forceinline__ void run(float* v, int lane) {
    if constexpr (O > 0) {
      if constexpr (N > 1) {
        const bool up = (lane & O) != 0;
#pragma unroll
        for (int q = 0; q < N / 2; ++q) {
          const float send = up ? v[q] : v[q + N / 2];
          const float keep = up ? v[q + N / 2] : v[q];
          v[q] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, O));
        }
        Fold<N / 2, O / 2>::run(v, lane);
      } else {
        v[0] = __fadd_rn(v[0], __shfl_xor_sync(kFull, v[0], O));
        Fold<1, O / 2>::run(v, lane);
      }
    }
  }
};

template <int DS>
__global__ void __launch_bounds__(kThreads) scan_bwd_states_kernel(const Args a) {
  __shared__ float sB[kChunk][DS];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < a.D;
  const int64_t row = (static_cast<int64_t>(b) * a.D + d) * DS;
  float h[DS], A[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    A[s] = live ? a.A[static_cast<int64_t>(d) * DS + s] : 0.f;
    h[s] = (live && a.h0 != nullptr) ? a.h0[row + s] : 0.f;
  }
  const int64_t seq = static_cast<int64_t>(b) * a.S;
  const int nc = (a.S + kChunk - 1) / kChunk;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * kChunk, n = min(kChunk, a.S - t0);
    if (live) {
      float* st = a.states + ((static_cast<int64_t>(b) * nc + c) * a.D + d) * DS;
#pragma unroll
      for (int s = 0; s < DS; ++s) st[s] = h[s];
    }
    __syncthreads();  // the previous chunk's reads of sB are done
    for (int i = threadIdx.x; i < n * DS; i += kThreads)
      sB[i / DS][i % DS] = a.Bc[(seq + t0 + i / DS) * DS + i % DS];
    float dtv[kChunk], xv[kChunk];
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      const bool in = live && tt < n;
      dtv[tt] = in ? a.dt[(seq + t0 + tt) * a.D + d] : 0.f;
      xv[tt] = in ? a.x[(seq + t0 + tt) * a.D + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      if (tt >= n) break;
      const float u = __fmul_rn(dtv[tt], xv[tt]);
#pragma unroll
      for (int s = 0; s < DS; ++s) {
        const float da = expf(__fmul_rn(dtv[tt], A[s]));
        h[s] = __fadd_rn(__fmul_rn(da, h[s]), __fmul_rn(u, sB[tt][s]));
      }
    }
  }
}

template <int DS>
__global__ void __launch_bounds__(kThreads) scan_bwd_reverse_kernel(const Args a) {
  constexpr int kSpread = 32 / DS;  // lanes holding one value after a fold of DS
  __shared__ float sB[kChunk][DS], sC[kChunk][DS];
  __shared__ float sdt[kChunk][kThreads], sx[kChunk][kThreads], sdy[kChunk][kThreads];
  __shared__ float sA[DS][kThreads];
  __shared__ float sred[kChunk][kWarps][2 * DS];  // [.][.][dB s, then dC s]
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int d = blockIdx.x * kThreads + tid;
  const bool live = d < a.D;
  const int64_t row = (static_cast<int64_t>(b) * a.D + d) * DS;
  const int64_t seq = static_cast<int64_t>(b) * a.S;
  float Gc[DS], dA[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    sA[s][tid] = live ? a.A[static_cast<int64_t>(d) * DS + s] : 0.f;
    Gc[s] = (live && a.dhT != nullptr) ? a.dhT[row + s] : 0.f;
    dA[s] = 0.f;
  }
  const int nc = (a.S + kChunk - 1) / kChunk;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kChunk, n = min(kChunk, a.S - t0);
    float hs[kChunk + 1][DS];  // hs[tt] = the state before token t0 + tt
    const float* st = a.states + ((static_cast<int64_t>(b) * nc + c) * a.D + d) * DS;
#pragma unroll
    for (int s = 0; s < DS; ++s) hs[0][s] = live ? st[s] : 0.f;
    __syncthreads();  // the previous chunk's reads of the staged rows and sred are done
    for (int i = tid; i < n * DS; i += kThreads) {
      const int64_t off = (seq + t0 + i / DS) * DS + i % DS;
      sB[i / DS][i % DS] = a.Bc[off];
      sC[i / DS][i % DS] = a.Cc[off];
    }
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      const bool in = live && tt < n;
      const int64_t off = (seq + t0 + tt) * a.D + d;
      sdt[tt][tid] = in ? a.dt[off] : 0.f;
      sx[tt][tid] = in ? a.x[off] : 0.f;
      sdy[tt][tid] = in ? a.dy[off] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      if (tt < n) {
        const float dtt = sdt[tt][tid], u = __fmul_rn(dtt, sx[tt][tid]);
#pragma unroll
        for (int s = 0; s < DS; ++s) {
          const float da = expf(__fmul_rn(dtt, sA[s][tid]));
          hs[tt + 1][s] = __fadd_rn(__fmul_rn(da, hs[tt][s]), __fmul_rn(u, sB[tt][s]));
        }
      }
    }
#pragma unroll
    for (int tt = kChunk - 1; tt >= 0; --tt) {
      if (tt < n) {
        const float dtt = sdt[tt][tid], xt = sx[tt][tid], dv = sdy[tt][tid];
        const float u = __fmul_rn(dtt, xt);
        float v[DS], du = 0.f, ddt_a = 0.f;
#pragma unroll
        for (int s = 0; s < DS; ++s) {
          const float G = __fadd_rn(__fmul_rn(sC[tt][s], dv), Gc[s]);
          du = __fadd_rn(du, __fmul_rn(G, sB[tt][s]));
          const float As = sA[s][tid];
          const float da = expf(__fmul_rn(dtt, As));
          const float gz = __fmul_rn(__fmul_rn(G, hs[tt][s]), da);
          ddt_a = __fadd_rn(ddt_a, __fmul_rn(gz, As));
          dA[s] = __fadd_rn(dA[s], __fmul_rn(gz, dtt));
          Gc[s] = __fmul_rn(da, G);
          v[s] = __fmul_rn(G, u);  // dB's term
        }
        if (live) {
          const int64_t off = (seq + t0 + tt) * a.D + d;
          a.ddt[off] = __fadd_rn(__fmul_rn(du, xt), ddt_a);
          a.dx[off] = __fmul_rn(du, dtt);
        }
        Fold<DS, 16>::run(v, lane);
        if (lane % kSpread == 0) sred[tt][warp][lane / kSpread] = v[0];
#pragma unroll
        for (int s = 0; s < DS; ++s) v[s] = __fmul_rn(dv, hs[tt + 1][s]);  // dC's term
        Fold<DS, 16>::run(v, lane);
        if (lane % kSpread == 0) sred[tt][warp][DS + lane / kSpread] = v[0];
      }
    }
    __syncthreads();
    for (int i = tid; i < n * 2 * DS; i += kThreads) {
      const int tt = i / (2 * DS), q = i % (2 * DS);
      float s = 0.f;
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp) s = __fadd_rn(s, sred[tt][wp][q]);
      a.bc_part[((static_cast<int64_t>(b) * gridDim.x + blockIdx.x) * a.S + t0 + tt) * (2 * DS)
                + q] = s;
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < DS; ++s) {
      if (a.dh0 != nullptr) a.dh0[row + s] = Gc[s];
      a.dA_part[row + s] = dA[s];
    }
  }
}

// dB, dC: the channel blocks' partials added in order; dA: the batch rows'
template <int DS>
__global__ void scan_bwd_reduce_kernel(const Args a, int nblocks) {
  constexpr int NV = 2 * DS;
  const int64_t n1 = static_cast<int64_t>(a.B) * a.S * NV;
  const int64_t n2 = static_cast<int64_t>(a.D) * DS;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; q < n1 + n2;
       q += stride) {
    if (q < n1) {
      const int64_t b = q / (static_cast<int64_t>(a.S) * NV), bt = q / NV;
      const int t = static_cast<int>(bt % a.S), v = static_cast<int>(q % NV);
      float s = 0.f;
      for (int k = 0; k < nblocks; ++k)
        s = __fadd_rn(s, a.bc_part[((b * nblocks + k) * a.S + t) * NV + v]);
      if (v < DS) a.dB[bt * DS + v] = s;
      else a.dC[bt * DS + v - DS] = s;
    } else {
      const int64_t j = q - n1;
      float s = 0.f;
      for (int bb = 0; bb < a.B; ++bb) s = __fadd_rn(s, a.dA_part[bb * n2 + j]);
      a.dA[j] = s;
    }
  }
}

template <int DS>
cudaError_t run(const Args& a, cudaStream_t st) {
  const int nblocks = (a.D + kThreads - 1) / kThreads;
  const dim3 grid(nblocks, a.B);
  scan_bwd_states_kernel<DS><<<grid, kThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_bwd_reverse_kernel<DS><<<grid, kThreads, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = static_cast<int64_t>(a.B) * a.S * 2 * DS + static_cast<int64_t>(a.D) * DS;
  const int blocks = static_cast<int>(n / 256 + 1 < 132 * 16 ? n / 256 + 1 : 132 * 16);
  scan_bwd_reduce_kernel<DS><<<blocks, 256, 0, st>>>(a, nblocks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tokens a chunk of the backward.  The caller sizes the scratch with it:
// states B ceil(S / chunk) D ds floats, dB / dC partials B ceil(D / 128) S
// 2 ds floats, dA partials B D ds floats.
int selective_scan_bwd_chunk(void) { return kChunk; }

// Every tensor contiguous f32 (layouts above); h0 and dhT may be null
// (zeros), dh0 null.  ds is 8 or 16; any other value is refused.
int selective_scan_bwd(const void* dt, const void* x, const void* A, const void* Bc,
                       const void* Cc, const void* h0, const void* dy, const void* dhT,
                       void* ddt, void* dx, void* dA, void* dB, void* dC, void* dh0,
                       void* states, void* bc_part, void* dA_part, int B, int S, int D, int ds,
                       void* stream) {
  if (B < 1 || S < 1 || D < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(dt), static_cast<const float*>(x),
               static_cast<const float*>(A), static_cast<const float*>(Bc),
               static_cast<const float*>(Cc), static_cast<const float*>(h0),
               static_cast<const float*>(dy), static_cast<const float*>(dhT),
               static_cast<float*>(ddt), static_cast<float*>(dx), static_cast<float*>(dA),
               static_cast<float*>(dB), static_cast<float*>(dC), static_cast<float*>(dh0),
               static_cast<float*>(states), static_cast<float*>(bc_part),
               static_cast<float*>(dA_part), B, S, D};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ds) {
    case 8: return static_cast<int>(run<8>(a, st));
    case 16: return static_cast<int>(run<16>(a, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
