// Hand-written Hopper (sm_90a) kernels of the attention forward pass.
//
// Both replace the TPU kernel
//   src/repro/kernels/flash_attention.py::flash_attention_bhsd
//   (Pallas body _flash_kernel):
// softmax(q k^T / sqrt(hd) [causal mask]) v for every (batch, query head),
// with an online softmax over key tiles, so the (S, T) score matrix never
// reaches device memory.
//
// What they compute (the plain version is
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
// and the kernel layout (BH, S, hd) onto it without a copy.  No atomics: a
// replay gives the same bits.  Neither kernel allocates; each launches on
// the caller's stream and returns cudaGetLastError().
//
// What bounds them on an H100: at SmolLM's prefill shape (8 x 9 heads,
// S = T = 1024, hd 64, bf16) the causal work is 9.67 GFLOP against 25.2 MB
// moved, so the tensor cores (989 TFLOP/s bf16) set the bound at 9.8 us:
// the kernel is bound by operations, and only the tensor cores come near.
//
// flash_tc_kernel (entry flash_attention_tc_fwd): bf16 q, k, v and o whose
// rows start 16-byte aligned, hd % 8 == 0, hd <= 128 -- every prefill
// launch of the serving path.  The design:
//   * one block of 256 threads per (128 query rows, query head, batch):
//     two consumer warpgroups of 64 rows each; the heaviest causal tiles
//     are issued first (the query tile is the slowest grid axis, reversed);
//   * Q (128 x HD) stays in shared memory for the whole block; K and V
//     tiles of 64 keys stream through a ring of 4 stages (3 at hd > 64),
//     copied by cp.async (commit / wait groups, zero fill past T and past
//     hd; each thread's addresses are worked out once), so later tiles
//     load while this one is computed;
//   * every tile is stored in the 128-byte swizzled layout that the
//     tensor cores' shared-memory operand descriptors read: rows of 64
//     bf16 (128 B), the 16-byte chunk c of row r at chunk c ^ (r % 8),
//     hd padded with zeros to 64 or 128 (two 64-column halves);
//   * S = Q K^T is wgmma.mma_async m64n64k16, bf16 x bf16 -> f32, both
//     operands K-major in shared memory;
//   * the online softmax stays in registers: the scores of a row sit in
//     one quad of lanes, so max and sum are two xor shuffles; scores are
//     kept in log2 units, s log2(e) / sqrt(hd), and p = 2^(s - m) on the
//     special function unit (ex2.approx, relative error below 2^-22);
//     off the diagonal and the ragged edge the scale folds into the
//     exponent's FMA, and a masked score is -1e30 as in the reference;
//   * P is rounded once to bf16 in registers, where the accumulator
//     layout of S is already the A-operand layout of the next product,
//     and O += P V is wgmma m64n{64,128}k16 with A from registers and V
//     read MN-major (transposed) from the same swizzled tile;
//   * O += P V of one tile and S of the next are issued back to back and
//     waited for together, so the tensor cores run them without a gap;
//     every branch around a wgmma depends on the block alone (ptxas
//     serialises the products of a wgmma under a thread-dependent branch),
//     so both warpgroups walk the block's key tiles;
//   * the epilogue is acc / max(l, 1e-30) (a product by the reciprocal),
//     rounded once to bf16.
// Rounding P to bf16 is what SDPA does too; the plain version keeps f32
// probabilities, and the kernel stays within the bf16 tolerance (2e-2)
// of it (tests/test_torch_attention.py emulates this arithmetic on the
// CPU).  What bounds it in practice is issue rate, not the tensor cores:
// the softmax costs about 200 instructions a thread for every 64-key tile,
// against 8 wgmma; two blocks (16 warps) share an SM at hd 64 so that one
// warpgroup's softmax overlaps another's products.

// flash_fwd_kernel (entry flash_attention_fwd): everything else -- f32
// inputs, and bf16 whose rows are not 16-byte aligned or whose hd is not a
// multiple of 8.  f32 on the CUDA cores and exact to 2e-6: one block of 256
// threads per (64 query rows, head, batch), the key tiles of 64 walked by
// a loop inside the block; Q^T, K^T, V and the probability tile sit in
// shared memory as f32 (67.6 KB for hd <= 64, 116.7 KB for hd <= 128);
// each thread owns a 4 x 4 block of scores and a 4 x (hd/16) block of the
// accumulator; the running max and sum stay in registers and the row
// reductions are 16-lane shuffles.  It runs on the CUDA cores (67 TFLOP/s
// f32 peak) and cannot come near the bound; the serving path never takes
// it.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kPS = kBK + 4;     // row stride of the probability tile
constexpr float kMasked = -1e30f;

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


// ---------------------------------------------------------------------------
// flash_tc_kernel: bf16 on the tensor cores
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBK = 64;  // keys per tile
// the launch's shape: two consumer warpgroups of 64 query rows a block, a
// K/V ring of STAGES tiles
template <int HD, int STAGES>
struct Shape {
  static constexpr int kThreads = 256;
  static constexpr int kBQ = 128;  // query rows a block
  static constexpr int kKV = kBK * HD * 2;  // bytes of one K or V tile
  // Q, the K and V rings, and slack to align to 1024
  static constexpr int kSmem = kBQ * HD * 2 + 2 * STAGES * kKV + 1024;
};

// Byte offset of the 16-byte chunk c (of HD / 8) of row r in a tile of
// ROWS rows: 64-column halves of ROWS x 128 B, each row's chunks swizzled
// by r % 8 (the 128-byte swizzle of the wgmma descriptors; tiles start on
// 1024-byte boundaries)
template <int ROWS>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>((c >> 3) * ROWS * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the tiles written by cp.async (generic proxy) become visible to wgmma
// (async proxy) after this fence and a barrier
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A shared-memory operand descriptor of wgmma: start address, leading and
// stride byte offsets (in 16-byte units) and the 128-byte swizzle (1 << 62).
// K-major (Q, K): the 8-row groups 1024 B apart (stride), the leading
// offset unused.  MN-major (V): 8-key groups 1024 B apart (stride), the
// 64-column halves ROWS x 128 B apart (leading).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across its wait.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define WG_D8(b)                                                              \
  "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]), \
      "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]^T, both from shared memory, K-major
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x N] += A[64 x 16] (registers) B[16 x N], B MN-major (transposed)
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef WG_D8

// 2^x on the special function unit (relative error below 2^-22, far under
// the bf16 rounding of P; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// This thread's share of the cp.async copies of a tile of ROWS rows of
// HD / 8 16-byte chunks: chunk c of rows r, r + STEP, ... (STEP a multiple
// of 8, so every row of the share has the same swizzle).  The addresses
// are worked out once; a tile adds its first row.  Rows at or past limit
// and chunks past hd are zero-filled.
template <int ROWS, int HD, int THREADS>
struct TileCopy {
  static constexpr int NC = HD / 8, STEP = THREADS / NC, N = ROWS / STEP;
  static_assert(STEP % 8 == 0 && ROWS % STEP == 0, "rows of a share keep one swizzle");
  uint32_t dst;                 // offset of the share's first chunk in the tile
  const __nv_bfloat16* src;     // row r, chunk c of the operand
  int r;
  bool col_in;

  __device__ __forceinline__ TileCopy(const __nv_bfloat16* base, int64_t rs, int hd, int tid) {
    const int c = tid % NC;
    r = tid / NC;
    dst = static_cast<uint32_t>((c >> 3) * ROWS * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
    src = base + r * rs + c * 8;
    col_in = c * 8 < hd;
  }
  __device__ __forceinline__ void issue(uint32_t tile, int row0, int limit, int64_t rs) const {
    const __nv_bfloat16* p = src + row0 * rs;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const bool in = col_in && row0 + r + j * STEP < limit;
      cp_async16(tile + dst + j * STEP * 128, in ? p + j * STEP * rs : src, in ? 16 : 0);
    }
  }
};

template <int HD, int STAGES>
__global__ void __launch_bounds__(256, HD == 64 ? 2 : 1)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int H,
                int KV, int S, int T_, int hd, int causal, float c2, int64_t qsb, int64_t qss,
                int64_t qsh, int64_t ksb, int64_t kst, int64_t ksh, int64_t vsb,
                int64_t vst, int64_t vsh, int64_t osb, int64_t oss, int64_t osh) {
  static_assert(STAGES >= 3, "the ring holds tiles t - 1 .. t + STAGES - 2");
  using Sh = Shape<HD, STAGES>;
  constexpr int kThreads = Sh::kThreads, kBQ = Sh::kBQ, kKV = Sh::kKV;
  constexpr int kNO = HD / 2;  // accumulator floats a thread (64 x HD over 128)
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sq = (raw + 1023u) & ~1023u;  // Q: [HD / 64][kBQ][64]
  const uint32_t sk = sq + kBQ * HD * 2;        // K ring: STAGES x [HD / 64][kBK][64]
  const uint32_t sv = sk + STAGES * kKV;        // V ring

  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // query rows wg * 64 .. + 63 of the block
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // heavy causal tiles first
  const int q0w = q0 + wg * 64;
  const int kvh = h / (H / KV);
  const int off = T_ - S;
  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + kvh * ksh;
  const __nv_bfloat16* vb = v + b * vsb + kvh * vsh;

  // keys the block needs: up to the last visible column of its last row,
  // or all of them when a row of the block sees none.  Every branch around
  // a wgmma depends on the block alone: ptxas serialises the products of a
  // wgmma issued under a condition that may differ between threads.
  int kv_end = T_;
  if (causal && q0 + off >= 0) kv_end = min(T_, min(q0 + kBQ, S) + off);
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  const TileCopy<kBK, HD, kThreads> kcopy(kb, kst, hd, tid), vcopy(vb, vst, hd, tid);
  auto load_kv = [&](int tile) {
    const int st = tile % STAGES;
    kcopy.issue(sk + st * kKV, tile * kBK, T_, kst);
    vcopy.issue(sv + st * kKV, tile * kBK, T_, vst);
  };
  TileCopy<kBQ, HD, kThreads>(qb, qss, hd, tid).issue(sq, q0, S, qss);
  load_kv(0);
  cp_async_commit();
#pragma unroll
  for (int t = 1; t < STAGES - 1; ++t) {
    if (t < n_tiles) load_kv(t);
    cp_async_commit();
  }

  // this thread's rows r0 and r0 + 8, and its column pair in each 8-column
  // chunk of the accumulators (the wgmma m64nN f32 layout)
  const int r0 = q0w + warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  // scores in log2 units: s * c2, c2 = log2(e) / sqrt(hd), so p = 2^(s - m)
  const uint32_t qdesc = sq + wg * 64 * 128;

  float s[32], acc[kNO];
  uint32_t pa[4][4];
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kNO; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) pa[kk][e] = 0u;

  // S = Q K^T of tile t on the tensor cores, issued, not waited for
  auto issue_qk = [&](int t) {
    const uint32_t kt = sk + (t % STAGES) * kKV;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      // 16 columns of hd a step: 32 B into a 128-byte row, then the next half
      const uint32_t kof = (ks & 3) * 32;
      mma_ss_n64(s, desc_sw128(qdesc + (ks >> 2) * kBQ * 128 + kof, 16, 1024),
                 desc_sw128(kt + (ks >> 2) * kBK * 128 + kof, 16, 1024), ks);
    }
    wg_commit();
  };

  // Softmax of tile t in place on s (scores in, probabilities out);
  // returns each row's correction of the running sums in corr.
  auto softmax_tile = [&](int t, float (&corr)[2]) {
    const int kv0 = t * kBK;
    // Scores in log2 units, s * c2.  A tile that reaches past T or across
    // the block's diagonal is scaled and masked here; any other tile keeps
    // its raw scores, and the scale folds into the exponent's FMA.
    const bool edge = kv0 + kBK > T_ || (causal && kv0 + kBK - 1 > q0 + off);
    if (edge) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = kv0 + (i >> 2) * 8 + cq + (i & 1);
        const int row = r0 + ((i >> 1) & 1) * 8;
        s[i] *= c2;
        if (col >= T_) s[i] = -INFINITY;
        else if (causal && col > row + off) s[i] = kMasked;
      }
    }
    const float sc = edge ? 1.f : c2;  // what still scales s
    // a row's 64 scores sit in one quad of lanes
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float t[8];  // the row's max as a tree: a short dependency chain
#pragma unroll
      for (int j = 0; j < 8; ++j) t[j] = fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]);
#pragma unroll
      for (int w = 4; w > 0; w >>= 1)
#pragma unroll
        for (int j = 0; j < w; ++j) t[j] = fmaxf(t[j], t[j + w]);
      float mt = t[0];
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      // column kv0 < T is in this tile, so mt is finite; scaling by sc > 0
      // keeps the max
      const float m_new = fmaxf(m_r[hh], mt * sc);
      corr[hh] = ex2(m_r[hh] - m_new);
      m_r[hh] = m_new;
      float ls[4] = {0.f, 0.f, 0.f, 0.f};  // four partial sums: a short chain
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          // 2^(s sc - m): exact 0 for s = m = -1e30 (a row that sees nothing)
          const float p = ex2(__fmaf_rn(s[4 * j + 2 * hh + c], sc, -m_new));
          s[4 * j + 2 * hh + c] = p;
          ls[j & 3] += p;
        }
      l_r[hh] = l_r[hh] * corr[hh] + ((ls[0] + ls[1]) + (ls[2] + ls[3]));
    }
  };
  // P, rounded once to bf16, is the A operand of O += P V: the score
  // accumulator's layout is already that of A, 16 keys a step
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
  };
  auto issue_pv = [&](int t) {
    const uint32_t vt = sv + (t % STAGES) * kKV;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs(acc, pa[kk], desc_sw128(vt + kk * 16 * 128, kBK * 128, 1024));
    wg_commit();
  };

  // Tile t: wait for S_t (and this warpgroup's P V_{t-1}), softmax,
  // rescale O, issue O += P_t V_t; then, once tile t + 1 has landed, issue
  // S_{t+1}, so the tensor cores run P_t V_t and S_{t+1} back to back.
  // The barrier before S_{t+1} also frees the ring slot of tile t - 1
  // (every warpgroup has waited for its P V_{t-1}), which takes tile
  // t + STAGES - 1.  (Commit group g holds tile g: every iteration commits
  // one, if empty.)
  cp_async_wait<STAGES - 2>();  // tile 0 (and Q) has landed: this thread's copies
  fence_async_proxy();
  __syncthreads();  // ... everyone's
  issue_qk(0);
  for (int it = 0; it < n_tiles; ++it) {
    wg_wait0();
    pin(s);
    pin(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pin(pa[kk]);
    float corr[2];
    softmax_tile(it, corr);
#pragma unroll
    for (int i = 0; i < kNO; ++i) acc[i] *= corr[(i >> 1) & 1];
    pack_p();
    issue_pv(it);
    if (it + 1 < n_tiles) {
      cp_async_wait<STAGES - 3>();  // tile it + 1 has landed
      fence_async_proxy();
      __syncthreads();  // everyone's copies; tile it - 1's slot is free
      if (it + STAGES - 1 < n_tiles) load_kv(it + STAGES - 1);
      cp_async_commit();
      issue_qk(it + 1);
    }
  }
  wg_wait0();
  pin(acc);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) pin(pa[kk]);

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l_r[hh];  // this thread's share of the row sum
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = r0 + hh * 8;
    if (row >= S) continue;
    // acc / max(l, 1e-30) as a product by the reciprocal: within an ulp of
    // f32 before the bf16 rounding
    const float inv_l = 1.0f / fmaxf(lt, 1e-30f);
    __nv_bfloat16* orow = o + b * osb + row * oss + h * osh;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = j * 8 + cq;
      if (col < hd)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            acc[4 * j + 2 * hh] * inv_l, acc[4 * j + 2 * hh + 1] * inv_l);
    }
  }
}

template <int HD, int STAGES>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                   int KV, int S, int T_, int hd, int causal, const int64_t* st,
                   cudaStream_t stream) {
  using Sh = Shape<HD, STAGES>;
  static bool configured = false;  // the attribute is set once, before any graph capture
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(flash_tc_kernel<HD, STAGES>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               Sh::kSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  if ((S + Sh::kBQ - 1) / Sh::kBQ > 65535) return cudaErrorInvalidValue;
  const dim3 grid(H, B, (S + Sh::kBQ - 1) / Sh::kBQ);
  flash_tc_kernel<HD, STAGES><<<grid, Sh::kThreads, Sh::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H, KV, S, T_, hd,
      causal, static_cast<float>(1.4426950408889634 / std::sqrt(static_cast<double>(hd))),
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

}  // namespace tc

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

// The tensor-core variant: bf16 q, k, v and o, every row start and the
// base pointers 16-byte aligned (strides multiples of 8 elements),
// hd % 8 == 0, 1 <= hd <= 128, H % KV == 0, T >= 1, B <= 65535,
// S <= 65535 * 128.  Strides as flash_attention_fwd's.
extern "C" int flash_attention_tc_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H, int KV, int S,
    int T, int hd, int causal, int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
    int64_t kst, int64_t ksh, int64_t vsb, int64_t vst, int64_t vsh, int64_t osb,
    int64_t oss, int64_t osh, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  const int64_t st[12] = {qsb, qss, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, oss, osh};
  bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                   reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  for (int i = 0; i < 12; ++i) aligned = aligned && st[i] % 8 == 0;
  if (T <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 || hd > 128 || hd % 8 != 0 ||
      B > 65535 || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      hd <= 64 ? tc::launch<64, 4>(q, k, v, o, B, H, KV, S, T, hd, causal, st, s)
               : tc::launch<128, 3>(q, k, v, o, B, H, KV, S, T, hd, causal, st, s);
  return static_cast<int>(e);
}
