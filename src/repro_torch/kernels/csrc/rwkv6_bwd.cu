// Hand-written Hopper (sm_90a) backward of the RWKV-6 WKV recurrence.
//
// wkv6_bwd replaces no TPU kernel.  The reference's Pallas kernel
// (src/repro/kernels/rwkv6.py::wkv6_bhsd) has no VJP; the reference trains
// RWKV6 by differentiating the lax.scan _wkv_scan
// (src/repro/models/ssm.py:218).  The port runs that scan's forward as
// csrc/rwkv6.cu, and its reverse as the three kernels of this file, the
// backward of repro_torch/kernels/rwkv6.py's autograd Function (plain
// version: rwkv6.py::wkv_bwd_ref).
//
// Per (batch b, head h), with the state S (hd x hd, f32), token t:
//   y_t = r_t . (S_{t-1} + diag(u) k_t v_tᵀ)
//   S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
// Given dy (and dS_T, or zeros), G_t = dL/dS_t runs in reverse,
//   G_{t-1} = diag(w_t) G_t + r_t dy_tᵀ
// and
//   dr_t[i] = sum_j dy_t[j] (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
//   dkv[i,j] = G_t[i,j] + r_t[i] u[i] dy_t[j]
//   dk_t[i] = sum_j dkv[i,j] v_t[j],   dv_t[j] = sum_i dkv[i,j] k_t[i]
//   dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
//   du[i]   = sum_{b,t} r_t[i] k_t[i] (v_t . dy_t)
//   ds0     = G before the first token.
//
// The recurrence is never inverted: w_t = exp(-exp(.)) underflows, so
// S_{t-1} is not (S_t - k v)/w.  The states are recomputed instead.
//   1. wkv6_bwd_states_kernel runs the forward recurrence, stores the state
//      at the start of every chunk of kChunk tokens in scratch, and computes
//      dr (a forward-direction quantity: it needs S_{t-1} and dy_t only).
//   2. wkv6_bwd_reverse_kernel walks the chunks from the last: it reloads a
//      chunk's start state, recomputes the chunk's states into shared
//      memory (each thread its own entries), then runs G backwards over the
//      chunk, writing dk, dw, per-block partial sums of dv, ds0 and the
//      per-batch-row partial sums of du.
//   3. wkv6_bwd_reduce_kernel adds the partials in a fixed order: dv over
//      the row groups, du over the batch.  No atomics anywhere, so two runs
//      give the same bits.
//
// Numerics.  Built with --fmad=false, every product and sum rounded alone
// (__fmul_rn / __fadd_rn) as the plain version rounds them: the recomputed
// states are the forward's bits, and the elementwise G (hence ds0) is the
// plain version's bit for bit.  The sums over j (dr, dk, dw, v.dy) run in
// j order within a thread and over a fixed xor tree across its row's
// threads; dv sums over i in a fixed tree within a warp and then over the
// warps and row groups in order; the plain version's einsums take other
// orders, so those gradients are held to it within a tolerance.
//
// Layout.  r, k, v, w, dy and the outputs dr, dk, dv, dw are (B, S, H, hd)
// contiguous f32; u is (Bu, H, hd) with Bu 1 (shared over the batch: du sums
// over b) or B; s0, dsT and ds0 are (B, H, hd, hd) and may be null (zeros,
// zeros, not wanted).
//
// Design.  A block owns 16 rows of one (b, h)'s state (all hd rows for hd
// 16), a thread 8 columns of one row (kSeg): hd / 8 threads a row, so the
// row sums (dr, dk, dw) stay within a warp.  The blocks of one (b, h) split
// its rows and add their dv contributions through the partial buffer.
//
// What bounds it on an H100 (RWKV6-7B training: B 8, S 1024, H 64, hd 64):
// reading r, k, v, w, dy and writing dr, dk, dv, dw moves 9 x 134 MB, 0.36
// ms at 3.35 TB/s; the 2.15e9 state entries each take ~18 f32 operations a
// token (the state recomputed, dr, dkv, dk, dv, dw, G), 0.58 ms at 67
// TFLOP/s.  This first kernel also writes and reads the chunk start states
// (537 MB at kChunk 16), the dv partials (4 x 134 MB), and keeps each
// chunk's states in shared memory, 93 KB a block (two blocks an SM);
// PERF.md has its times.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSeg = 8;                  // state columns a thread owns
constexpr unsigned kFull = 0xffffffffu;

template <int HD>
struct Tile {
  static constexpr int kRows = HD < 16 ? HD : 16;       // state rows a block
  static constexpr int kTpr = HD / kSeg;                // threads a row
  static constexpr int kThreads = kRows * kTpr;         // 32, 64, 128, 256
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kGroups = HD / kRows;            // blocks a (b, h)
  static constexpr int kChunk = HD == 128 ? 8 : 16;     // tokens a chunk
  static constexpr int kSmemFloats =
      kChunk * (kSeg * kThreads + 2 * HD + 3 * kRows + kWarps * HD);
};

struct Args {
  const float *r, *k, *v, *w, *u, *s0, *dy, *dsT;
  float *dr, *dk, *dv, *dw, *du, *ds0;
  float *states, *dv_part, *du_part;
  int B, S, H, u_batched;
};

// sum over the TPR threads of a row, the same bits in each of them
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) x = __fadd_rn(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// sum over the rows of a warp (the lanes TPR, 2 TPR, ... apart)
template <int TPR>
__device__ __forceinline__ float col_sum(float x) {
#pragma unroll
  for (int o = TPR; o < 32; o <<= 1) x = __fadd_rn(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

template <int HD>
__global__ void __launch_bounds__(Tile<HD>::kThreads) wkv6_bwd_states_kernel(const Args a) {
  using T = Tile<HD>;
  constexpr int C = T::kChunk, R = T::kRows;
  __shared__ float sv[C][HD], sdy[C][HD], sk[C][R], sw[C][R];
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int il = threadIdx.x / T::kTpr, seg = threadIdx.x % T::kTpr;
  const int i = blockIdx.y * R + il, j0 = seg * kSeg;
  const int64_t tok = static_cast<int64_t>(a.H) * HD;
  const int64_t base = static_cast<int64_t>(b) * a.S * tok + static_cast<int64_t>(h) * HD;
  const float ui = a.u[(static_cast<int64_t>(a.u_batched ? b : 0) * a.H + h) * HD + i];
  const int64_t srow = (static_cast<int64_t>(bh) * HD + i) * HD + j0;
  float S[kSeg];
#pragma unroll
  for (int e = 0; e < kSeg; ++e) S[e] = a.s0 != nullptr ? a.s0[srow + e] : 0.f;
  const int nc = (a.S + C - 1) / C;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * C, n = min(C, a.S - t0);
    float* st = a.states + ((static_cast<int64_t>(bh) * nc + c) * HD + i) * HD + j0;
#pragma unroll
    for (int e = 0; e < kSeg; ++e) st[e] = S[e];
    __syncthreads();  // the previous chunk's reads of the staged rows are done
    for (int q = threadIdx.x; q < n * HD; q += T::kThreads) {
      const int tt = q / HD, j = q % HD;
      const int64_t off = base + (t0 + tt) * tok + j;
      sv[tt][j] = a.v[off];
      sdy[tt][j] = a.dy[off];
    }
    for (int q = threadIdx.x; q < n * R; q += T::kThreads) {
      const int tt = q / R, ii = q % R;
      const int64_t off = base + (t0 + tt) * tok + blockIdx.y * R + ii;
      sk[tt][ii] = a.k[off];
      sw[tt][ii] = a.w[off];
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float ki = sk[tt][il], wi = sw[tt][il];
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < kSeg; ++e) {
        const float kv = __fmul_rn(ki, sv[tt][j0 + e]);
        part = __fadd_rn(part, __fmul_rn(sdy[tt][j0 + e], __fadd_rn(S[e], __fmul_rn(ui, kv))));
        S[e] = __fadd_rn(__fmul_rn(wi, S[e]), kv);
      }
      const float dri = row_sum<T::kTpr>(part);
      if (seg == 0) a.dr[base + (t0 + tt) * tok + i] = dri;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(Tile<HD>::kThreads) wkv6_bwd_reverse_kernel(const Args a) {
  using T = Tile<HD>;
  constexpr int C = T::kChunk, R = T::kRows, NT = T::kThreads, NW = T::kWarps;
  extern __shared__ float smem[];
  float* sS = smem;                  // [C][kSeg][NT]: each thread's recomputed states
  float* sv = sS + C * kSeg * NT;    // [C][HD]
  float* sdy = sv + C * HD;          // [C][HD]
  float* sr = sdy + C * HD;          // [C][R]
  float* sk = sr + C * R;            // [C][R]
  float* sw = sk + C * R;            // [C][R]
  float* sdv = sw + C * R;           // [C][NW][HD]: each warp's dv over its rows
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int il = tid / T::kTpr, seg = tid % T::kTpr;
  const int i = blockIdx.y * R + il, j0 = seg * kSeg;
  const int64_t tok = static_cast<int64_t>(a.H) * HD;
  const int64_t base = static_cast<int64_t>(b) * a.S * tok + static_cast<int64_t>(h) * HD;
  const int64_t total = static_cast<int64_t>(a.B) * a.S * tok;
  const float ui = a.u[(static_cast<int64_t>(a.u_batched ? b : 0) * a.H + h) * HD + i];
  const int64_t srow = (static_cast<int64_t>(bh) * HD + i) * HD + j0;
  float G[kSeg], S[kSeg];
#pragma unroll
  for (int e = 0; e < kSeg; ++e) G[e] = a.dsT != nullptr ? a.dsT[srow + e] : 0.f;
  float du_acc = 0.f;
  const int nc = (a.S + C - 1) / C;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * C, n = min(C, a.S - t0);
    const float* st = a.states + ((static_cast<int64_t>(bh) * nc + c) * HD + i) * HD + j0;
#pragma unroll
    for (int e = 0; e < kSeg; ++e) S[e] = st[e];
    __syncthreads();  // the previous chunk's reads of the staged rows and sdv are done
    for (int q = tid; q < n * HD; q += NT) {
      const int tt = q / HD, j = q % HD;
      const int64_t off = base + (t0 + tt) * tok + j;
      sv[tt * HD + j] = a.v[off];
      sdy[tt * HD + j] = a.dy[off];
    }
    for (int q = tid; q < n * R; q += NT) {
      const int tt = q / R, ii = q % R;
      const int64_t off = base + (t0 + tt) * tok + blockIdx.y * R + ii;
      sr[tt * R + ii] = a.r[off];
      sk[tt * R + ii] = a.k[off];
      sw[tt * R + ii] = a.w[off];
    }
    __syncthreads();
    // the chunk's states S_{t-1}, recomputed from its start
    for (int tt = 0; tt < n; ++tt) {
      const float ki = sk[tt * R + il], wi = sw[tt * R + il];
#pragma unroll
      for (int e = 0; e < kSeg; ++e) {
        sS[(tt * kSeg + e) * NT + tid] = S[e];
        S[e] = __fadd_rn(__fmul_rn(wi, S[e]), __fmul_rn(ki, sv[tt * HD + j0 + e]));
      }
    }
    for (int tt = n - 1; tt >= 0; --tt) {
      const float ri = sr[tt * R + il], ki = sk[tt * R + il], wi = sw[tt * R + il];
      const float ru = __fmul_rn(ri, ui);
      float pk = 0.f, pw = 0.f, pvd = 0.f, col[kSeg];
#pragma unroll
      for (int e = 0; e < kSeg; ++e) {
        const float vj = sv[tt * HD + j0 + e], dyj = sdy[tt * HD + j0 + e];
        const float dkv = __fadd_rn(G[e], __fmul_rn(ru, dyj));
        pk = __fadd_rn(pk, __fmul_rn(dkv, vj));
        pw = __fadd_rn(pw, __fmul_rn(G[e], sS[(tt * kSeg + e) * NT + tid]));
        pvd = __fadd_rn(pvd, __fmul_rn(vj, dyj));
        col[e] = __fmul_rn(dkv, ki);
        G[e] = __fadd_rn(__fmul_rn(wi, G[e]), __fmul_rn(ri, dyj));
      }
      const float dki = row_sum<T::kTpr>(pk), dwi = row_sum<T::kTpr>(pw);
      const float vdy = row_sum<T::kTpr>(pvd);
      du_acc = __fadd_rn(du_acc, __fmul_rn(__fmul_rn(ri, ki), vdy));
      if (seg == 0) {
        const int64_t off = base + (t0 + tt) * tok + i;
        a.dk[off] = dki;
        a.dw[off] = dwi;
      }
#pragma unroll
      for (int e = 0; e < kSeg; ++e) col[e] = col_sum<T::kTpr>(col[e]);
      if (lane < T::kTpr) {  // the warp's first row: lane == seg
#pragma unroll
        for (int e = 0; e < kSeg; ++e) sdv[(tt * NW + warp) * HD + j0 + e] = col[e];
      }
    }
    __syncthreads();
    for (int q = tid; q < n * HD; q += NT) {
      const int tt = q / HD, j = q % HD;
      float s = 0.f;
      for (int wp = 0; wp < NW; ++wp) s = __fadd_rn(s, sdv[(tt * NW + wp) * HD + j]);
      a.dv_part[blockIdx.y * total + base + (t0 + tt) * tok + j] = s;
    }
  }
  if (a.ds0 != nullptr) {
#pragma unroll
    for (int e = 0; e < kSeg; ++e) a.ds0[srow + e] = G[e];
  }
  if (seg == 0) a.du_part[(static_cast<int64_t>(b) * a.H + h) * HD + i] = du_acc;
}

// dv: the row groups' partials added in order; du: the batch rows' partials
// added in order (or copied, for a per-batch-row u)
__global__ void wkv6_bwd_reduce_kernel(const Args a, int hd, int groups) {
  const int64_t n1 = static_cast<int64_t>(a.B) * a.S * a.H * hd;
  const int64_t hh = static_cast<int64_t>(a.H) * hd;
  const int64_t n2 = a.u_batched ? a.B * hh : hh;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; q < n1 + n2;
       q += stride) {
    if (q < n1) {
      float s = 0.f;
      for (int g = 0; g < groups; ++g) s = __fadd_rn(s, a.dv_part[g * n1 + q]);
      a.dv[q] = s;
    } else if (a.u_batched) {
      a.du[q - n1] = a.du_part[q - n1];
    } else {
      float s = 0.f;
      for (int bb = 0; bb < a.B; ++bb) s = __fadd_rn(s, a.du_part[bb * hh + (q - n1)]);
      a.du[q - n1] = s;
    }
  }
}

template <int HD>
cudaError_t run(const Args& a, cudaStream_t st) {
  using T = Tile<HD>;
  const dim3 grid(a.B * a.H, T::kGroups);
  wkv6_bwd_states_kernel<HD><<<grid, T::kThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = T::kSmemFloats * static_cast<int>(sizeof(float));
  static bool sized = false;  // once an instantiation: the call may be in a graph capture
  if (!sized) {
    err = cudaFuncSetAttribute(wkv6_bwd_reverse_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  wkv6_bwd_reverse_kernel<HD><<<grid, T::kThreads, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = static_cast<int64_t>(a.B) * a.H * HD * (a.S + 1);
  const int blocks = static_cast<int>(n / 256 + 1 < 132 * 16 ? n / 256 + 1 : 132 * 16);
  wkv6_bwd_reduce_kernel<<<blocks, 256, 0, st>>>(a, HD, T::kGroups);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tokens a chunk of the backward at head dim hd (0: hd not built).  The
// caller sizes the scratch with it: states B H ceil(S / chunk) hd hd floats,
// dv partials (hd / min(hd, 16)) B S H hd floats, du partials B H hd floats.
int wkv6_bwd_chunk(int hd) {
  switch (hd) {
    case 16: return Tile<16>::kChunk;
    case 32: return Tile<32>::kChunk;
    case 64: return Tile<64>::kChunk;
    case 128: return Tile<128>::kChunk;
    default: return 0;
  }
}

// Every tensor contiguous f32 (layouts above).  s0, dsT and ds0 may be null.
// u_batched: u is (B, H, hd) (else (1, H, hd), and du sums over the batch).
int wkv6_bwd(const void* r, const void* k, const void* v, const void* w, const void* u,
             const void* s0, const void* dy, const void* dsT, void* dr, void* dk, void* dv,
             void* dw, void* du, void* ds0, void* states, void* dv_part, void* du_part,
             int B, int S, int H, int hd, int u_batched, void* stream) {
  if (B < 1 || S < 1 || H < 1 || static_cast<int64_t>(B) * H >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(r), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(w),
               static_cast<const float*>(u), static_cast<const float*>(s0),
               static_cast<const float*>(dy), static_cast<const float*>(dsT),
               static_cast<float*>(dr), static_cast<float*>(dk), static_cast<float*>(dv),
               static_cast<float*>(dw), static_cast<float*>(du), static_cast<float*>(ds0),
               static_cast<float*>(states), static_cast<float*>(dv_part),
               static_cast<float*>(du_part), B, S, H, u_batched};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return static_cast<int>(run<16>(a, st));
    case 32: return static_cast<int>(run<32>(a, st));
    case 64: return static_cast<int>(run<64>(a, st));
    case 128: return static_cast<int>(run<128>(a, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
