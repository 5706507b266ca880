// Hand-written Hopper (sm_90a) kernels of the int8 (+delta) checkpoint codec.
//
// ckpt_quantize replaces the TPU kernel
//   src/repro/kernels/ckpt_codec.py::quantize_blocks
//   (Pallas bodies _quant_kernel and _quant_delta_kernel):
// blockwise absmax int8 codes of x, or of x - prev, over 256-element blocks,
// with one f32 scale per block.
//
// ckpt_dequantize replaces the TPU kernel
//   src/repro/kernels/ckpt_codec.py::dequantize_blocks (kern, kern_delta):
// q * s, plus prev for the delta variant.
//
// Both compute what the host codec computes (repro_torch/checkpoint/codec.py,
// which owns the file format), bit for bit, and not the Pallas kernels'
// arithmetic: the Pallas quantizer multiplies by a reciprocal of 127, so its
// scales sit 1 ulp off the host's in about 4% of blocks, and the Pallas delta
// dequantize rounds q * s + prev once (an FMA) where the host rounds twice.
// Last-bit rules:
//   scale = absmax / 127 by IEEE division (__fdiv_rn), then max(scale,
//           f32(1e-12)), the floor being numpy's double 1e-12 rounded to f32;
//           a block holding a NaN gets |that NaN| as its scale, payload and
//           all, as numpy's max, divide and maximum pass it on (fmaxf would
//           drop it; the block's NaNs are taken to share one payload);
//   code  = clip(rint(x / scale), -127, 127), rint rounding half to even; a
//           NaN quotient codes 0, as numpy's cast gives on x86 (an Inf block
//           has scale Inf, and its Inf elements code 0);
//   delta = x - prev in f32 first;
//   out   = __fadd_rn(__fmul_rn(q, s), prev): the intrinsics keep the two
//           roundings whatever the compiler flags.
//
// Layout: the leaf is read flat with its length n, in blocks of 256; elements
// past n count as 0, so no padded copy of the leaf is made (the reference's
// ops.quantize_checkpoint pads with jnp.pad, a second pass over the leaf).
// Quantize: one warp per block, 8 elements a lane as two float4 loads (lane l
// holds elements 4l..4l+3 and 128+4l..128+4l+3, so each load instruction of
// the warp reads 512 contiguous bytes), a warp-shuffle absmax, codes stored
// as two 32-bit words a lane, the scale by lane 0.  Dequantize: one thread
// per 4 elements (a char4 of codes, a float4 of prev and of output), all in
// one 256-block so one scale.  The ragged tail, and any pointer the wrapper
// found not 16-byte aligned, take scalar loads.  Kernels allocate nothing,
// launch on the caller's stream, and return cudaGetLastError().
//
// What bounds them on an H100: a handful of operations per element against
// 5 bytes moved (4 read, 1 written; 9 with prev), so device memory is the
// roofline (3.35 TB/s): the design is one pass over the leaf, coalesced
// 16-byte loads, every intermediate in registers, no shared memory.

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 256;  // codec block (repro_torch.kernels.ckpt_codec.BLOCK)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kMaxCtas = 132 * 32;
constexpr float kScaleFloor = static_cast<float>(1e-12);

// |v| by clearing the sign bit: keeps a NaN's payload, which the abs
// instruction need not
__device__ __forceinline__ float magnitude(float v) {
  return __int_as_float(__float_as_int(v) & 0x7fffffff);
}

// max that keeps a NaN once seen, as numpy's max does
__device__ __forceinline__ float nan_max(float m, float a) {
  return (a > m || isnan(a)) ? a : m;
}

// This lane's 8 elements of the block starting at `start`.
__device__ __forceinline__ void load8(const float* __restrict__ x,
                                      int64_t start, int64_t n, int lane,
                                      bool vec, float v[8]) {
  if (vec) {
    const float4 a = *reinterpret_cast<const float4*>(x + start + lane * 4);
    const float4 b =
        *reinterpret_cast<const float4*>(x + start + 128 + lane * 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int64_t i = start + (j < 4 ? lane * 4 + j : 128 + lane * 4 + j - 4);
    v[j] = i < n ? x[i] : 0.0f;
  }
}

__device__ __forceinline__ uint32_t code(float v, float s) {
  const float r = rintf(__fdiv_rn(v, s));
  const int c = isnan(r) ? 0 : static_cast<int>(fminf(fmaxf(r, -127.0f), 127.0f));
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(c)));
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(int64_t n, int64_t nb, const float* __restrict__ x,
                const float* __restrict__ prev, int8_t* __restrict__ q,
                float* __restrict__ s, int aligned) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * kThreads) >> 5;
  for (int64_t b = warp; b < nb; b += n_warps) {  // warp-uniform
    const int64_t start = b * kBlock;
    const bool vec = aligned && start + kBlock <= n;
    float v[8];
    load8(x, start, n, lane, vec, v);
    if (prev != nullptr) {
      float p[8];
      load8(prev, start, n, lane, vec, p);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __fsub_rn(v[j], p[j]);
    }
    float m = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) m = nan_max(m, magnitude(v[j]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    // a NaN skips the division, which would put the card's canonical NaN in
    // place of the data's payload that numpy passes on
    const float sc = isnan(m) ? m : fmaxf(__fdiv_rn(m, 127.0f), kScaleFloor);
    const uint32_t lo = code(v[0], sc) | code(v[1], sc) << 8 |
                        code(v[2], sc) << 16 | code(v[3], sc) << 24;
    const uint32_t hi = code(v[4], sc) | code(v[5], sc) << 8 |
                        code(v[6], sc) << 16 | code(v[7], sc) << 24;
    *reinterpret_cast<uint32_t*>(q + start + lane * 4) = lo;
    *reinterpret_cast<uint32_t*>(q + start + 128 + lane * 4) = hi;
    if (lane == 0) s[b] = sc;
  }
}

__device__ __forceinline__ float decode(int8_t c, float sc) {
  return __fmul_rn(static_cast<float>(c), sc);
}

__global__ void __launch_bounds__(kThreads)
dequantize_kernel(int64_t n, const int8_t* __restrict__ q,
                  const float* __restrict__ s, const float* __restrict__ prev,
                  float* __restrict__ out, int aligned) {
  const int64_t n4 = (n + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       t < n4; t += stride) {
    const int64_t i = t * 4;
    const float sc = s[i / kBlock];
    if (aligned && i + 4 <= n) {
      const char4 c = *reinterpret_cast<const char4*>(q + i);
      float4 o = make_float4(decode(c.x, sc), decode(c.y, sc),
                             decode(c.z, sc), decode(c.w, sc));
      if (prev != nullptr) {
        const float4 p = *reinterpret_cast<const float4*>(prev + i);
        o.x = __fadd_rn(o.x, p.x);
        o.y = __fadd_rn(o.y, p.y);
        o.z = __fadd_rn(o.z, p.z);
        o.w = __fadd_rn(o.w, p.w);
      }
      *reinterpret_cast<float4*>(out + i) = o;
    } else {
      for (int64_t k = i; k < i + 4 && k < n; ++k) {
        float o = decode(q[k], sc);
        if (prev != nullptr) o = __fadd_rn(o, prev[k]);
        out[k] = o;
      }
    }
  }
}

unsigned int ctas_for(int64_t work, int64_t per_cta) {
  const int64_t b = (work + per_cta - 1) / per_cta;
  return static_cast<unsigned int>(b < kMaxCtas ? b : kMaxCtas);
}

}  // namespace

// x, prev: n floats (prev may be null); q: nb * 256 codes, s: nb scales,
// nb = ceil(n / 256).  `aligned`: x and prev are 16-byte aligned.
extern "C" int ckpt_quantize(int64_t n, const float* x, const float* prev,
                             int8_t* q, float* s, int32_t aligned,
                             void* stream) {
  const int64_t nb = (n + kBlock - 1) / kBlock;
  if (nb <= 0) return 0;
  quantize_kernel<<<ctas_for(nb, kWarps), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(n, nb, x, prev, q, s,
                                                         aligned);
  return static_cast<int>(cudaGetLastError());
}

// q: ceil(n / 256) * 256 codes, s: ceil(n / 256) scales, prev: n floats (may
// be null), out: n floats.  `aligned`: q is 4-byte and prev 16-byte aligned
// (out is a fresh allocation).
extern "C" int ckpt_dequantize(int64_t n, const int8_t* q, const float* s,
                               const float* prev, float* out, int32_t aligned,
                               void* stream) {
  if (n <= 0) return 0;
  dequantize_kernel<<<ctas_for((n + 3) / 4, kThreads), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(n, q, s, prev, out,
                                                           aligned);
  return static_cast<int>(cudaGetLastError());
}
