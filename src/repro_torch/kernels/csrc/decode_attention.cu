// Hand-written Hopper (sm_90a) kernel of one decode step's attention.
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
// pos is read by the kernel from device memory, the counterpart of the
// Pallas scalar prefetch: the host never reads it, so a decode step needs
// no host sync and can be captured in a CUDA graph.
//
// GQA is resolved here: one block per (KV head, batch) serves that KV
// head's H / KV query heads, so each cache row is read from device memory
// once for all of them, straight from the (B, S_max, KV, hd) cache, with no
// repeated copy.  Operands are strided like flash_attention.cu's: q and o
// (batch, head), k and v (batch, seq, head), hd contiguous.  q may be f32
// while the cache is bf16 (f32 compute over the bf16 serving cache).
//
// Design: 256 threads (8 warps); the live rows are walked in tiles of 256.
// Scores: one row a thread, its K row read once (16-byte loads) for up to
// four query heads at a time.  Softmax: one warp per query head takes the
// tile's max, the probabilities and their sum.  Weighted sum: each warp
// takes every 8th row of the tile, its 32 lanes reading the V row as one
// coalesced line (hd / 32 columns a lane) and folding it into its own
// partial accumulator for every head; the 8 partials are summed in a fixed
// order at the end.  Scores, probabilities, partial accumulators and
// running max / sum sit in shared memory (9.8 KB for SmolLM).  No atomics:
// a replay gives the same bits.  The kernel allocates nothing, launches on
// the caller's stream and returns cudaGetLastError().
//
// What bounds it on an H100: the live cache, 6,144 (pos + 1) bytes per
// layer for SmolLM at batch 8 (6.3-7.1 MB, 1.9-2.1 us at 3.35 TB/s); the
// arithmetic is negligible.  With B * KV = 24 blocks the card is far from
// full, and the launch itself (a few us) is of the same order, so this
// kernel is launch-bound at serving batch sizes; splitting the rows over
// more blocks needs a second combining pass and is left for later.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 256;  // cache rows per tile: one a thread
constexpr int kGC = 4;      // query heads handled together
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// p[0..n) as f32, zeros past n (n <= 8).  vec: p is 16-byte aligned.
__device__ __forceinline__ void load8(const float* p, int n, bool vec, float v[8]) {
  if (vec && n == 8) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < n ? p[e] : 0.f;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, int n, bool vec, float v[8]) {
  if (vec && n == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < n ? __bfloat162float(p[e]) : 0.f;
  }
}

__host__ __device__ constexpr int pad_hd(int hd) { return hd <= 64 ? 64 : 128; }

__host__ __device__ inline int smem_floats(int G, int HD) {
  return G * HD + G * kTile + kWarps * G * HD + 3 * G;
}

template <typename TQ, typename TK, int HD>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
              const TK* __restrict__ v, const int* __restrict__ pos_p,
              TQ* __restrict__ o, int H, int KV, int S, int hd, int vec,
              int64_t qsb, int64_t qsh, int64_t ksb, int64_t kst,
              int64_t ksh, int64_t vsb, int64_t vst, int64_t vsh,
              int64_t osb, int64_t osh) {
  constexpr int kDPL = HD / 32;  // V columns a lane
  extern __shared__ float4 smem4[];
  const int G = H / KV;
  float* qs = reinterpret_cast<float*>(smem4);  // [G][HD] queries
  float* ps = qs + G * HD;                      // [G][kTile] scores, then p
  float* accw = ps + G * kTile;                 // [kWarps][G][HD] partial sums
  float* run_m = accw + kWarps * G * HD;        // [G] running max
  float* run_l = run_m + G;                     // [G] running sum
  float* corr = run_l + G;                      // [G] this tile's correction

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int pos = *pos_p;
  const bool uniform = pos < 0;
  const int n_keys = uniform ? S : min(pos, S - 1) + 1;
  const bool vecb = vec != 0;
  const float sq = sqrtf(static_cast<float>(hd));
  const TK* kb = k + b * ksb + kvh * ksh;
  const TK* vb = v + b * vsb + kvh * vsh;

  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    qs[i] = d < hd ? to_f32(q[b * qsb + (kvh * G + g) * qsh + d]) : 0.f;
  }
  for (int i = tid; i < kWarps * G * HD; i += kThreads) accw[i] = 0.f;
  for (int g = tid; g < G; g += kThreads) {
    run_m[g] = -INFINITY;
    run_l[g] = 0.f;
  }
  __syncthreads();

  for (int t0 = 0; t0 < n_keys; t0 += kTile) {
    // scores: row t0 + tid, up to kGC query heads per pass over the K row
    const int t = t0 + tid;
    const bool live = t < n_keys;
    const TK* kr = kb + t * kst;
    for (int g0 = 0; g0 < G; g0 += kGC) {
      const int gn = min(kGC, G - g0);
      float dot[kGC] = {0.f, 0.f, 0.f, 0.f};
      if (live) {
        for (int c = 0; c * 8 < hd; ++c) {
          float kv8[8];
          load8(kr + c * 8, min(8, hd - c * 8), vecb, kv8);
#pragma unroll
          for (int gi = 0; gi < kGC; ++gi) {
            if (gi < gn) {
              const float* qg = qs + (g0 + gi) * HD + c * 8;
#pragma unroll
              for (int e = 0; e < 8; ++e) dot[gi] = fmaf(qg[e], kv8[e], dot[gi]);
            }
          }
        }
      }
#pragma unroll
      for (int gi = 0; gi < kGC; ++gi)  // rows past the live ones weigh exactly 0
        if (gi < gn)
          ps[(g0 + gi) * kTile + tid] =
              live ? (uniform ? kMasked : __fdiv_rn(dot[gi], sq)) : -INFINITY;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float* pg = ps + g * kTile;
      float mx = -INFINITY;
      for (int j = lane; j < kTile; j += 32) mx = fmaxf(mx, pg[j]);
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      // row t0 is live, so mx is finite
      const float m_new = fmaxf(run_m[g], mx);
      float sum = 0.f;
      for (int j = lane; j < kTile; j += 32) {
        const float p = expf(pg[j] - m_new);
        pg[j] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      sum = __shfl_sync(0xffffffffu, sum, 0);
      if (lane == 0) {
        const float c = expf(run_m[g] - m_new);
        corr[g] = c;
        run_m[g] = m_new;
        run_l[g] = run_l[g] * c + sum;
      }
    }
    __syncthreads();

    // weighted sum: this warp's rows of the tile into its partial sums
    const int nt = min(kTile, n_keys - t0);
    const int d0 = lane * kDPL;
    for (int g0 = 0; g0 < G; g0 += kGC) {
      const int gn = min(kGC, G - g0);
      float a[kGC][kDPL];
#pragma unroll
      for (int gi = 0; gi < kGC; ++gi)
#pragma unroll
        for (int e = 0; e < kDPL; ++e)
          a[gi][e] = gi < gn ? accw[(warp * G + g0 + gi) * HD + d0 + e] * corr[g0 + gi] : 0.f;
#pragma unroll 4
      for (int j = warp; j < nt; j += kWarps) {
        const TK* vr = vb + (t0 + j) * vst + d0;
        float vv[kDPL];
#pragma unroll
        for (int e = 0; e < kDPL; ++e) vv[e] = d0 + e < hd ? to_f32(vr[e]) : 0.f;
#pragma unroll
        for (int gi = 0; gi < kGC; ++gi) {
          if (gi < gn) {
            const float p = ps[(g0 + gi) * kTile + j];
#pragma unroll
            for (int e = 0; e < kDPL; ++e) a[gi][e] = fmaf(p, vv[e], a[gi][e]);
          }
        }
      }
#pragma unroll
      for (int gi = 0; gi < kGC; ++gi)
        if (gi < gn)
#pragma unroll
          for (int e = 0; e < kDPL; ++e) accw[(warp * G + g0 + gi) * HD + d0 + e] = a[gi][e];
    }
    __syncthreads();
  }

  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    if (d >= hd) continue;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += accw[(w * G + g) * HD + d];
    store_as(o + b * osb + (kvh * G + g) * osh + d, __fdiv_rn(acc, fmaxf(run_l[g], 1e-30f)));
  }
}

template <typename TQ, typename TK, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* pos, void* o, int B, int H, int KV, int S,
                   int hd, int vec, const int64_t* st, cudaStream_t stream) {
  const size_t smem = smem_floats(H / KV, HD) * sizeof(float);
  if (smem > 48 * 1024) {
    // only for large query groups (SmolLM's needs 9.8 KB); never reached
    // inside a graph capture by the serving path
    const cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<TQ, TK, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(KV, B);
  decode_kernel<TQ, TK, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(k),
      static_cast<const TK*>(v), pos, static_cast<TQ*>(o), H, KV, S, hd, vec,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9]);
  return cudaGetLastError();
}

template <typename TQ, typename TK>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v,
                        const int* pos, void* o, int B, int H, int KV, int S,
                        int hd, int vec, const int64_t* st, cudaStream_t s) {
  return hd <= 64 ? launch<TQ, TK, 64>(q, k, v, pos, o, B, H, KV, S, hd, vec, st, s)
                  : launch<TQ, TK, 128>(q, k, v, pos, o, B, H, KV, S, hd, vec, st, s);
}

}  // namespace

// q_dtype / kv_dtype: 0 = float32, 1 = bfloat16; o has q's type.  pos: a
// device pointer to one int32.  Strides in elements: q and o (batch, head),
// k and v (batch, seq, head).  vec: every cache row start is 16-byte
// aligned and hd % 8 == 0.  Requires 1 <= hd <= 128, H % KV == 0, S >= 1.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* pos, void* o,
    int q_dtype, int kv_dtype, int B, int H, int KV, int S, int hd, int vec,
    int64_t qsb, int64_t qsh, int64_t ksb, int64_t kst, int64_t ksh,
    int64_t vsb, int64_t vst, int64_t vsh, int64_t osb, int64_t osh,
    void* stream) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (S <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 || hd > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_floats(H / KV, pad_hd(hd)) * sizeof(float) > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[10] = {qsb, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, osh};
  const int* p = static_cast<const int*>(pos);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 0)
    e = dispatch_hd<float, float>(q, k, v, p, o, B, H, KV, S, hd, vec, st, s);
  else if (q_dtype == 0 && kv_dtype == 1)
    e = dispatch_hd<float, __nv_bfloat16>(q, k, v, p, o, B, H, KV, S, hd, vec, st, s);
  else if (q_dtype == 1 && kv_dtype == 0)
    e = dispatch_hd<__nv_bfloat16, float>(q, k, v, p, o, B, H, KV, S, hd, vec, st, s);
  else if (q_dtype == 1 && kv_dtype == 1)
    e = dispatch_hd<__nv_bfloat16, __nv_bfloat16>(q, k, v, p, o, B, H, KV, S, hd, vec, st, s);
  return static_cast<int>(e);
}
