// Hand-written Hopper (sm_90a) kernel of the attention forward pass.
//
// flash_attention_fwd replaces the TPU kernel
//   src/repro/kernels/flash_attention.py::flash_attention_bhsd
//   (Pallas body _flash_kernel):
// softmax(q k^T / sqrt(hd) [causal mask]) v for every (batch, query head),
// with an online softmax over key tiles, so the (S, T) score matrix never
// reaches device memory.
//
// What it computes (the plain version is
// repro_torch/kernels/flash_attention.py::flash_attention_ref):
//   score  = (q . k) / sqrt(hd), in f32 whatever the input type;
//   causal = column c is visible from row r iff c <= r + (T - S), the
//            prefix offset of models/layers._dense_attn (for prefill S = T,
//            the Pallas kernel's rows >= cols); a masked score is -1e30, as
//            in the reference, so a row with no visible column averages v
//            over all T columns as jax.nn.softmax does;
//   out    = acc / max(l, 1e-30), rounded once to the input type.
// Any S and T: the ragged edge is masked (the Pallas entry asserted that
// the blocks divide S and T).  Tiles wholly above the diagonal are skipped,
// unless a row of the block sees no column at all (S > T).
//
// GQA is resolved here: query head h reads KV head h / (H / KV) of the
// unrepeated K/V, through strides, so the caller's jnp.repeat (3x the K/V
// bytes for SmolLM) is never made.  Layout: every operand is 4-D
// (batch, seq, head, hd) with hd contiguous and the other three strides
// given in elements; the wrapper maps both the model layout (B, S, H, hd)
// and the kernel layout (BH, S, hd) onto it without a copy.
//
// Design: one block of 256 threads per (query tile of 64 rows, head,
// batch), the key tiles of 64 walked by a loop inside the block in place
// of the TPU's sequential grid axis; heavy (late) query tiles are issued
// first.  Q^T, K^T, V and the probability tile sit in shared memory as f32
// (67.6 KB for hd <= 64, 116.7 KB for hd <= 128, dynamic); each thread owns
// a 4 x 4 block of scores and a 4 x (hd/16) block of the accumulator, both
// fed by 16-byte shared loads; the running max and sum stay in registers
// and the row reductions are 16-lane shuffles.  No atomics: a replay gives
// the same bits.  The kernel allocates nothing, launches on the caller's
// stream and returns cudaGetLastError().
//
// What bounds it on an H100: at SmolLM's prefill shape (8 x 9 heads,
// S = T = 1024, hd 64, bf16) the causal work is 9.67 GFLOP against 25.2 MB
// moved, so the tensor cores (989 TFLOP/s bf16) set the bound at 9.8 us.
// This first version computes in f32 on the CUDA cores (67 TFLOP/s peak),
// so it cannot come near that bound; it is the simple, exact baseline that
// a later mma/wgmma version is held to.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kPS = kBK + 4;     // row stride of the probability tile
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

template <int HD>
constexpr int smem_floats() {
  return HD * kBQ + HD * kBK + kBK * (HD + 4) + kBQ * kPS;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int KV,
                 int S, int T_, int hd, int causal, int vec, int64_t qsb,
                 int64_t qss, int64_t qsh, int64_t ksb, int64_t kst,
                 int64_t ksh, int64_t vsb, int64_t vst, int64_t vsh,
                 int64_t osb, int64_t oss, int64_t osh) {
  constexpr int kVS = HD + 4;    // row stride of the V tile
  constexpr int kDC = HD / 64;   // float4 groups of accumulator columns
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [HD][kBQ]  Q tile, transposed
  float* kt = qt + HD * kBQ;                    // [HD][kBK]  K tile, transposed
  float* vs = kt + HD * kBK;                    // [kBK][kVS] V tile
  float* ps = vs + kBK * kVS;                   // [kBQ][kPS] probabilities

  const int tid = threadIdx.x;
  const int ty = tid >> 4;   // rows ty*4 .. ty*4+3 of the block
  const int tx = tid & 15;   // score columns tx*4 .. +3; acc columns tx*4 (+64)
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int off = T_ - S;
  const bool vecb = vec != 0;
  const float sq = sqrtf(static_cast<float>(hd));
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  for (int i = tid; i < kBQ * (HD / 8); i += kThreads) {
    const int r = i % kBQ, c = i / kBQ, row = q0 + r;
    const int n = row < S ? max(0, min(8, hd - c * 8)) : 0;
    float x[8];
    load8(qb + row * qss + c * 8, n, vecb, x);
#pragma unroll
    for (int e = 0; e < 8; ++e) qt[(c * 8 + e) * kBQ + r] = x[e];
  }

  // keys this block needs: up to the last visible column of its last row,
  // or all of them when a row of the block sees none
  int kv_end = T_;
  if (causal && q0 + off >= 0) kv_end = min(T_, min(q0 + kBQ, S) + off);

  float m[4], l[4], acc[4][4 * kDC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * kDC; ++e) acc[i][e] = 0.f;
  }

  for (int kv0 = 0; kv0 < kv_end; kv0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and qt is written)
    for (int i = tid; i < kBK * (HD / 8); i += kThreads) {
      const int r = i % kBK, c = i / kBK, col = kv0 + r;
      const int n = col < T_ ? max(0, min(8, hd - c * 8)) : 0;
      float x[8];
      load8(kb + col * kst + c * 8, n, vecb, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) kt[(c * 8 + e) * kBK + r] = x[e];
      load8(vb + col * vst + c * 8, n, vecb, x);
      float4* dst = reinterpret_cast<float4*>(vs + r * kVS + c * 8);
      dst[0] = make_float4(x[0], x[1], x[2], x[3]);
      dst[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a4 = *reinterpret_cast<const float4*>(qt + d * kBQ + ty * 4);
      const float4 b4 = *reinterpret_cast<const float4*>(kt + d * kBK + tx * 4);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kv0 + tx * 4 + j;
        float x = __fdiv_rn(s[i][j], sq);
        if (col >= T_) x = -INFINITY;
        else if (causal && col > row + off) x = kMasked;
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, w, 16));
      // col kv0 < T_ is in this tile, so mt is finite
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr;
#pragma unroll
      for (int e = 0; e < 4 * kDC; ++e) acc[i][e] *= corr;
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = expf(s[i][j] - m_new);
        l[i] += p[j];
      }
      *reinterpret_cast<float4*>(ps + (ty * 4 + i) * kPS + tx * 4) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();

    for (int c = 0; c < kBK; c += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * kPS + c);
        pr[i][0] = t.x; pr[i][1] = t.y; pr[i][2] = t.z; pr[i][3] = t.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int g = 0; g < kDC; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(vs + (c + cc) * kVS + g * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][g * 4 + 0] = fmaf(pr[i][cc], vv.x, acc[i][g * 4 + 0]);
            acc[i][g * 4 + 1] = fmaf(pr[i][cc], vv.y, acc[i][g * 4 + 1]);
            acc[i][g * 4 + 2] = fmaf(pr[i][cc], vv.z, acc[i][g * 4 + 2]);
            acc[i][g * 4 + 3] = fmaf(pr[i][cc], vv.w, acc[i][g * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];  // this thread's share of the row sum
#pragma unroll
    for (int w = 8; w > 0; w >>= 1) li += __shfl_xor_sync(0xffffffffu, li, w, 16);
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float den = fmaxf(li, 1e-30f);
    T* orow = o + b * osb + row * oss + h * osh;
#pragma unroll
    for (int g = 0; g < kDC; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = g * 64 + tx * 4 + e;
        if (d < hd) store_as(orow + d, __fdiv_rn(acc[i][g * 4 + e], den));
      }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int S, int T_, int hd, int causal,
                   int vec, const int64_t* st, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<HD>() * sizeof(float);
  static bool configured = false;  // the attribute is set once, before any graph capture
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KV, S, T_, hd, causal,
      vec, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11]);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike).  Strides in
// elements, per operand (batch, seq, head): q, k, v, o.  vec: every row
// start is 16-byte aligned and hd % 8 == 0.  Requires 1 <= hd <= 128,
// H % KV == 0, T >= 1.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int KV, int S, int T, int hd, int causal, int vec, int64_t qsb,
    int64_t qss, int64_t qsh, int64_t ksb, int64_t kst, int64_t ksh,
    int64_t vsb, int64_t vst, int64_t vsh, int64_t osb, int64_t oss,
    int64_t osh, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (T <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 || hd > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[12] = {qsb, qss, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, oss, osh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = hd <= 64 ? launch<float, 64>(q, k, v, o, B, H, KV, S, T, hd, causal, vec, st, s)
                 : launch<float, 128>(q, k, v, o, B, H, KV, S, T, hd, causal, vec, st, s);
  } else if (dtype == 1) {
    e = hd <= 64
            ? launch<__nv_bfloat16, 64>(q, k, v, o, B, H, KV, S, T, hd, causal, vec, st, s)
            : launch<__nv_bfloat16, 128>(q, k, v, o, B, H, KV, S, T, hd, causal, vec, st, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
