// Hand-written Hopper (sm_90a) kernels of one decode step's attention.
//
// decode_attention_fwd replaces the TPU kernel
//   src/repro/kernels/decode_attention.py::decode_attention_bhd
//   (Pallas body _decode_kernel):
// one query row per (batch, query head) against a KV cache of S_max rows,
// of which rows 0..pos take part.
//
// What it computes (the plain version is
// repro_torch/kernels/decode_attention.py::decode_attention_ref, the math
// of models/layers.attention_decode):
//   score = (q . k_t) / sqrt(hd) in f32, for t <= pos;
//   out   = sum_t softmax(score)_t v_t / max(l, 1e-30), rounded once to q's
//           type.
// Rows after pos are left out (the reference gives them -1e30, whose
// weight is exactly 0); a pos < 0 leaves every row at -1e30, and the
// softmax is then uniform over all S_max rows, as in the reference.
//
// pos is read by the kernels from device memory, the counterpart of the
// Pallas scalar prefetch: the host never reads it, and no grid size depends
// on it, so a decode step needs no host sync and can be captured in a CUDA
// graph and replayed at any pos.
//
// GQA is resolved here: a block serves the H / KV query heads of one KV
// head, so each cache row is read from device memory once for all of them,
// straight from the (B, S_max, KV, hd) cache, with no repeated copy.
// Operands are strided like flash_attention.cu's: q and o (batch, head),
// k and v (batch, seq, head), hd contiguous.  q may be f32 while the cache
// is bf16 (f32 compute over the bf16 serving cache).
//
// What bounds it on an H100: the live cache, 6,144 (pos + 1) bytes per
// layer for SmolLM at batch 8 (6.3-7.1 MB, 1.9-2.1 us at 3.35 TB/s); the
// arithmetic is negligible, so the kernel is bound by bytes, and the
// bytes come in at the card's rate only when many SMs stream at once.
// One block per (KV head, batch) would be 24 blocks on 132 SMs.
//
// Design (flash-decoding): a call is two kernels on the caller's stream.
//   1. decode_split_kernel, grid (splits, KV, B) with splits =
//      ceil(S_max / R): the live rows are cut into splits of R =
//      kSplitRows = 128 rows, fixed at compile time (a sweep of 32, 64 and
//      128 on the H100 chose it, PERF.md section 6), each a block -- 9
//      live splits x 24 = 216 blocks at SmolLM's pos 1087.  The
//      grid is sized from S_max, which the host knows; a block whose split
//      starts past pos returns at once.  R * hd / 32 threads, each holding
//      one 8-element chunk of four rows of K and of V, all loaded before
//      any arithmetic (predicated 16-byte loads where rows are aligned; the
//      query's chunks beside the load of pos).  Scores, four
//      query heads of the group a pass: a chunk's partial dots with the
//      query's chunk (loaded straight into registers), summed over the
//      row's hd / 8 lanes by xor shuffles; the split's max, probabilities
//      and sum by one warp per head; the weighted sum of V, four heads a
//      pass, summed over lanes, then over warps in a fixed order.  The
//      split's max m, sum l and unnormalised f32 accumulator go to a
//      scratch (B, H, splits, hd + 2) that the wrapper allocates.
//   2. decode_combine_kernel, one warp per (batch, query head), launched
//      as a programmatic dependent launch: its blocks start while the
//      split kernel runs and wait for its end in griddepcontrol.wait (the
//      launch gap is hidden; inside a CUDA graph the dependency is kept).
//      The splits' maxima and sums and the first 16 splits' accumulators
//      are then loaded at once (from L2); the live splits 0 .. ceil(n / R)
//      - 1 (n the live rows: pos + 1, or S_max for pos < 0) are merged in
//      split order, each rescaled by exp(m_s - m), and the sum is divided
//      by max(l, 1e-30) and rounded once to q's type.
// Both kernels are short chains of dependent steps (the load of pos, the
// cache loads, shuffles and barriers), so at this size latency, not the
// card's memory rate, sets their time.  No atomics and a fixed order
// everywhere: a replay gives the same bits.  Neither kernel allocates;
// each returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <cmath>
#include <cstring>

namespace {

constexpr float kMasked = -1e30f;
constexpr int kSplitRows = 128;    // cache rows a block of the split kernel
constexpr int kRowsPerThread = 4;  // a thread's rows of one split (one chunk each)
constexpr int kCombineWarps = 4;   // (batch, head) pairs a combine block
constexpr int kGC = 4;             // query heads a pass of the split kernel

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// p[0..n) as f32, zeros past n (n <= 8), one element at a time (rows
// that are not 16-byte aligned, or hd % 8 != 0)
template <typename T>
__device__ __forceinline__ void load8(const T* p, int n, float v[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = e < n ? static_cast<float>(p[e]) : 0.f;
}

// 16 bytes at p, or zeros where !in: one predicated load and no branch,
// so that a thread's loads are all in flight before the first use
__device__ __forceinline__ uint4 ld16(const void* p, bool in) {
  uint4 u;
  asm("{\n.reg .pred q;\nsetp.ne.b32 q, %5, 0;\n"
      "mov.b32 %0, 0;\nmov.b32 %1, 0;\nmov.b32 %2, 0;\nmov.b32 %3, 0;\n"
      "@q ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n}\n"
      : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
      : "l"(p), "r"(static_cast<int>(in)));
  return u;
}

// 16-byte words of an 8-element chunk: 1 of bf16, 2 of f32
template <typename T>
__host__ __device__ constexpr int chunk_words() { return static_cast<int>(sizeof(T)) / 2; }

template <typename T>
__device__ __forceinline__ void ld_chunk(const T* p, bool in, uint4 (&u)[chunk_words<T>()]) {
#pragma unroll
  for (int j = 0; j < chunk_words<T>(); ++j) u[j] = ld16(p + j * (8 / chunk_words<T>()), in);
}

// the chunk's 8 values as f32 (a bf16 is the high half of its f32)
__device__ __forceinline__ void widen(const uint4 (&u)[1], float v[8]) {
  const uint32_t w[4] = {u[0].x, u[0].y, u[0].z, u[0].w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[2 * e] = __uint_as_float(w[e] << 16);
    v[2 * e + 1] = __uint_as_float(w[e] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void widen(const uint4 (&u)[2], float v[8]) {
  v[0] = __uint_as_float(u[0].x); v[1] = __uint_as_float(u[0].y);
  v[2] = __uint_as_float(u[0].z); v[3] = __uint_as_float(u[0].w);
  v[4] = __uint_as_float(u[1].x); v[5] = __uint_as_float(u[1].y);
  v[6] = __uint_as_float(u[1].z); v[7] = __uint_as_float(u[1].w);
}

// rows that take part: pos + 1 (at most S), or all S for pos < 0
__device__ __forceinline__ int live_rows(int pos, int S) {
  return pos < 0 ? S : min(pos, S - 1) + 1;
}

__host__ __device__ constexpr int split_threads(int R, int HD) {
  return R * (HD / 8) / kRowsPerThread;
}

__host__ __device__ inline int split_smem_floats(int G, int R, int HD) {
  return G * R + (split_threads(R, HD) / 32) * G * HD;
}

// q . k / sqrt(hd) (sq = sqrtf(hd), inv = 1 / sq, from the host): a
// product by the reciprocal where sqrt(hd) is a power of two (the same bits
// as the division), else the division
__device__ __forceinline__ float scale_score(float dot, float sq, float inv, int pow2) {
  return pow2 ? dot * inv : __fdiv_rn(dot, sq);
}

template <typename TQ, typename TK, int HD, bool VEC>
__global__ void __launch_bounds__(split_threads(kSplitRows, HD))
decode_split_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
                    const TK* __restrict__ v, const int* __restrict__ pos_p,
                    float* __restrict__ part, int H, int KV, int S, int hd, float sq,
                    float inv, int pow2, int64_t qsb, int64_t qsh, int64_t ksb, int64_t kst,
                    int64_t ksh, int64_t vsb, int64_t vst, int64_t vsh) {
  constexpr int R = kSplitRows;
  constexpr int NC = HD / 8;                         // 8-element chunks of a row
  constexpr int kThreads = split_threads(R, HD);
  constexpr int kWarps = kThreads / 32;
  constexpr int kRowStep = kThreads / NC;            // rows apart of a thread's rows
  constexpr int WQ = chunk_words<TQ>(), WK = chunk_words<TK>();
  // the combine kernel may be launched now: it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = tid % NC, rsub = tid / NC;
  const int cn = max(0, min(8, hd - c * 8));    // live elements of chunk c
  const TK* kb = k + b * ksb + kvh * ksh + c * 8;
  const TK* vb = v + b * vsb + kvh * vsh + c * 8;
  const TQ* qb = q + b * qsb + kvh * G * qsh + c * 8;

  // With VEC, every load is one or two predicated 16-byte loads, issued
  // before any use: the first pass's query chunks alongside the load of
  // pos, then this thread's four rows of K and V.
  uint4 qr[kGC][WQ], kr[kRowsPerThread][WK], vr[kRowsPerThread][WK];
  if constexpr (VEC) {
#pragma unroll
    for (int gi = 0; gi < kGC; ++gi) ld_chunk(qb + gi * qsh, gi < G && cn == 8, qr[gi]);
  }
  const int pos = *pos_p;
  const int n_keys = live_rows(pos, S);
  const int t0 = split * R;
  if (t0 >= n_keys) return;  // past the live rows: the combine never reads it
  const int nr = min(R, n_keys - t0);
  const bool uniform = pos < 0;
  const int splits = gridDim.x;

  extern __shared__ float4 smem4[];
  float* ps = reinterpret_cast<float*>(smem4);  // [G][R] scores, then p
  float* red = ps + G * R;                      // [kWarps][G][HD] per-warp sums

  float kf[kRowsPerThread][8], vf[kRowsPerThread][8];
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = rsub + i * kRowStep;
      ld_chunk(kb + (t0 + r) * kst, r < nr && cn == 8, kr[i]);
      ld_chunk(vb + (t0 + r) * vst, r < nr && cn == 8, vr[i]);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      widen(kr[i], kf[i]);
      widen(vr[i], vf[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = rsub + i * kRowStep;
      const int n = r < nr ? cn : 0;
      load8(kb + (t0 + r) * kst, n, kf[i]);
      load8(vb + (t0 + r) * vst, n, vf[i]);
    }
  }

  // scores, kGC query heads a pass: a chunk's partial dots with the
  // query's chunk, summed over the row's NC lanes
  for (int g0 = 0; g0 < G; g0 += kGC) {
    float dot[kGC][kRowsPerThread];
#pragma unroll
    for (int gi = 0; gi < kGC; ++gi) {
      float qf[8];
      if constexpr (VEC) {
        if (g0 > 0) ld_chunk(qb + (g0 + gi) * qsh, g0 + gi < G && cn == 8, qr[gi]);
        widen(qr[gi], qf);
      } else {
        load8(qb + (g0 + gi) * qsh, g0 + gi < G ? cn : 0, qf);
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(qf[e], kf[i][e], d);
        dot[gi][i] = d;
      }
    }
    const int gn = min(kGC, G - g0);  // heads of this pass (block-uniform)
#pragma unroll
    for (int w = NC / 2; w > 0; w >>= 1)
#pragma unroll
      for (int gi = 0; gi < kGC; ++gi)
        if (gi < gn)
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
            dot[gi][i] += __shfl_xor_sync(0xffffffffu, dot[gi][i], w);
    if (c == 0) {
#pragma unroll
      for (int gi = 0; gi < kGC; ++gi) {
        if (g0 + gi >= G) break;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const int r = rsub + i * kRowStep;  // rows past the live ones weigh exactly 0
          ps[(g0 + gi) * R + r] =
              r < nr ? (uniform ? kMasked : scale_score(dot[gi][i], sq, inv, pow2)) : -INFINITY;
        }
      }
    }
  }
  __syncthreads();

  // the split's max, probabilities and sum, one warp per head
  float* out_g = part + (static_cast<int64_t>(b) * H + kvh * G) * splits * (hd + 2) +
                 static_cast<int64_t>(split) * (hd + 2);
  for (int g = warp; g < G; g += kWarps) {
    float* pg = ps + g * R;
    float x[R / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < R / 32; ++j) {
      x[j] = pg[lane + 32 * j];
      mx = fmaxf(mx, x[j]);
    }
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    // row t0 is live, so mx is finite
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < R / 32; ++j) {
      const float p = expf(x[j] - mx);
      pg[lane + 32 * j] = p;
      sum += p;
    }
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
    if (lane == 0) {
      float* og = out_g + static_cast<int64_t>(g) * splits * (hd + 2);
      og[hd] = mx;
      og[hd + 1] = sum;
    }
  }
  __syncthreads();

  // the weighted sum of V, kGC heads a pass: over a thread's rows, the
  // lanes of the same chunk, then (below) the warps in order
  for (int g0 = 0; g0 < G; g0 += kGC) {
    float a[kGC][8];
#pragma unroll
    for (int gi = 0; gi < kGC; ++gi)
#pragma unroll
      for (int e = 0; e < 8; ++e) a[gi][e] = 0.f;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
      for (int gi = 0; gi < kGC; ++gi) {
        const float p = g0 + gi < G ? ps[(g0 + gi) * R + rsub + i * kRowStep] : 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) a[gi][e] = fmaf(p, vf[i][e], a[gi][e]);
      }
    }
    const int gn = min(kGC, G - g0);
#pragma unroll
    for (int w = 16; w >= NC; w >>= 1)
#pragma unroll
      for (int gi = 0; gi < kGC; ++gi)
        if (gi < gn)
#pragma unroll
          for (int e = 0; e < 8; ++e) a[gi][e] += __shfl_xor_sync(0xffffffffu, a[gi][e], w);
    if (lane < NC) {
#pragma unroll
      for (int gi = 0; gi < kGC; ++gi) {
        if (g0 + gi >= G) break;
#pragma unroll
        for (int e = 0; e < 8; ++e) red[(warp * G + g0 + gi) * HD + c * 8 + e] = a[gi][e];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    if (d >= hd) continue;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += red[(w * G + g) * HD + d];
    out_g[static_cast<int64_t>(g) * splits * (hd + 2) + d] = acc;
  }
}

template <typename TQ, int HD>
__global__ void __launch_bounds__(kCombineWarps * 32)
decode_combine_kernel(const float* __restrict__ part, const int* __restrict__ pos_p,
                      TQ* __restrict__ o, int BH, int H, int S, int hd, int splits,
                      int64_t osb, int64_t osh) {
  constexpr int R = kSplitRows;
  constexpr int kDL = HD / 32;  // columns a lane
  constexpr int kBatch = 16;    // splits whose columns are loaded at once
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x * kCombineWarps + (threadIdx.x >> 5);
  if (bh >= BH) return;
  const int b = bh / H, h = bh % H;
  const int ld = hd + 2;
  const float* pp = part + static_cast<int64_t>(bh) * splits * ld;
  const int pos = *pos_p;  // the split kernel does not write pos
  // Launched while the split kernel runs (programmatic dependent launch):
  // wait for its end and its partials.  They are read at L2 (ld.cg), never
  // from an L1 line of an earlier call's scratch at the same address.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  // the first 32 splits' max and sum (one a lane) and the first kBatch
  // splits' columns are all loaded before any is used
  const bool s_in = lane < splits;
  const float my_m = s_in ? __ldcg(pp + lane * ld + hd) : -INFINITY;
  const float my_l = s_in ? __ldcg(pp + lane * ld + hd + 1) : 0.f;
  float x[kBatch][kDL];
#pragma unroll
  for (int j = 0; j < kBatch; ++j)
#pragma unroll
    for (int e = 0; e < kDL; ++e) {
      const int d = lane + 32 * e;
      x[j][e] = j < splits && d < hd ? __ldcg(pp + j * ld + d) : 0.f;
    }
  const int live = min(splits, (live_rows(pos, S) + R - 1) / R);

  float m = lane < live ? my_m : -INFINITY;
  for (int s = lane + 32; s < live; s += 32) m = fmaxf(m, __ldcg(pp + s * ld + hd));
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, w));
  // the weight of split s, exp(m_s - m): lane s holds it for s < 32
  const float my_w = lane < live ? expf(my_m - m) : 0.f;
  float l = lane < live ? my_w * my_l : 0.f;  // a stale split's sum may be anything
  for (int s = lane + 32; s < live; s += 32)
    l += expf(__ldcg(pp + s * ld + hd) - m) * __ldcg(pp + s * ld + hd + 1);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) l += __shfl_xor_sync(0xffffffffu, l, w);

  // the columns' sums over the live splits, in split order
  float acc[kDL];
#pragma unroll
  for (int e = 0; e < kDL; ++e) acc[e] = 0.f;
  for (int s0 = 0; s0 < live; s0 += kBatch) {
    if (s0 > 0) {
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
#pragma unroll
        for (int e = 0; e < kDL; ++e) {
          const int d = lane + 32 * e;
          x[j][e] = s0 + j < live && d < hd ? __ldcg(pp + (s0 + j) * ld + d) : 0.f;
        }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int s = s0 + j;
      float w = __shfl_sync(0xffffffffu, my_w, s & 31);
      if (s >= 32 && s < live) w = expf(__ldcg(pp + s * ld + hd) - m);
      if (s < live) {
#pragma unroll
        for (int e = 0; e < kDL; ++e) acc[e] += w * x[j][e];
      }
    }
  }
  const float den = fmaxf(l, 1e-30f);
  TQ* orow = o + b * osb + h * osh;
#pragma unroll
  for (int e = 0; e < kDL; ++e) {
    const int d = lane + 32 * e;
    if (d < hd) store_as(orow + d, __fdiv_rn(acc[e], den));
  }
}

template <typename TQ, typename TK, int HD>
cudaError_t launch_split(const void* q, const void* k, const void* v, const int* pos,
                         float* part, int B, int H, int KV, int S, int hd, int vec,
                         int splits, const int64_t* st, cudaStream_t stream) {
  const size_t smem = split_smem_floats(H / KV, kSplitRows, HD) * sizeof(float);
  const auto kernel = vec ? decode_split_kernel<TQ, TK, HD, true>
                          : decode_split_kernel<TQ, TK, HD, false>;
  if (smem > 48 * 1024) {
    // only for large query groups (SmolLM's needs 7.5 KB at 128 rows a
    // split); never reached inside a graph capture by the serving path
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(splits, KV, B);
  const float sq = std::sqrt(static_cast<float>(hd));  // IEEE: the same bits as the card's
  uint32_t sq_bits;
  std::memcpy(&sq_bits, &sq, sizeof sq_bits);
  kernel<<<grid, split_threads(kSplitRows, HD), smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(k), static_cast<const TK*>(v), pos,
      part, H, KV, S, hd, sq, 1.0f / sq, (sq_bits & 0x7FFFFFu) == 0u, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7]);
  return cudaGetLastError();
}

template <typename TQ, typename TK, int HD>
cudaError_t run_hd(const void* q, const void* k, const void* v, const int* pos, float* part,
                   void* o, int B, int H, int KV, int S, int hd, int vec, int splits,
                   const int64_t* st, cudaStream_t s) {
  cudaError_t e =
      launch_split<TQ, TK, HD>(q, k, v, pos, part, B, H, KV, S, hd, vec, splits, st, s);
  if (e != cudaSuccess) return e;
  const int BH = B * H;
  // programmatic dependent launch: the combine's blocks start while the
  // split kernel runs and wait for it in griddepcontrol.wait
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((BH + kCombineWarps - 1) / kCombineWarps);
  cfg.blockDim = dim3(kCombineWarps * 32);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, decode_combine_kernel<TQ, HD>, static_cast<const float*>(part),
                         pos, static_cast<TQ*>(o), BH, H, S, hd, splits, st[8], st[9]);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename TQ, typename TK>
cudaError_t run(const void* q, const void* k, const void* v, const int* pos, float* part,
                void* o, int B, int H, int KV, int S, int hd, int vec, int splits,
                const int64_t* st, cudaStream_t s) {
  return hd <= 64 ? run_hd<TQ, TK, 64>(q, k, v, pos, part, o, B, H, KV, S, hd, vec, splits, st, s)
                  : run_hd<TQ, TK, 128>(q, k, v, pos, part, o, B, H, KV, S, hd, vec, splits, st, s);
}

}  // namespace

// q_dtype / kv_dtype: 0 = float32, 1 = bfloat16; o has q's type.  pos: a
// device pointer to one int32.  part: f32 scratch of B * H * splits *
// (hd + 2) floats, splits = ceil(S / 128).  Strides in
// elements: q and o (batch, head), k and v (batch, seq, head).  vec: every
// query and cache row start is 16-byte aligned and hd % 8 == 0.  Requires
// 1 <= hd <= 128, H % KV == 0, S >= 1.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* pos, void* part, void* o,
    int q_dtype, int kv_dtype, int B, int H, int KV, int S, int hd, int vec, int64_t qsb,
    int64_t qsh, int64_t ksb, int64_t kst, int64_t ksh, int64_t vsb, int64_t vst, int64_t vsh,
    int64_t osb, int64_t osh, void* stream) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (S <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 || hd > 128 || B > 65535 || KV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (split_smem_floats(H / KV, kSplitRows, hd <= 64 ? 64 : 128) * sizeof(float) > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (S + kSplitRows - 1) / kSplitRows;
  const int64_t st[10] = {qsb, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, osh};
  const int* p = static_cast<const int*>(pos);
  float* pt = static_cast<float*>(part);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 0)
    e = run<float, float>(q, k, v, p, pt, o, B, H, KV, S, hd, vec, splits, st, s);
  else if (q_dtype == 0 && kv_dtype == 1)
    e = run<float, __nv_bfloat16>(q, k, v, p, pt, o, B, H, KV, S, hd, vec, splits, st, s);
  else if (q_dtype == 1 && kv_dtype == 0)
    e = run<__nv_bfloat16, float>(q, k, v, p, pt, o, B, H, KV, S, hd, vec, splits, st, s);
  else if (q_dtype == 1 && kv_dtype == 1)
    e = run<__nv_bfloat16, __nv_bfloat16>(q, k, v, p, pt, o, B, H, KV, S, hd, vec, splits, st, s);
  return static_cast<int>(e);
}
