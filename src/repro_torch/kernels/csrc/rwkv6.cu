// Hand-written Hopper (sm_90a) kernel of the RWKV-6 (Finch) WKV recurrence.
//
// wkv6_fwd replaces the TPU kernel
//   src/repro/kernels/rwkv6.py::wkv6_bhsd (Pallas body _wkv_kernel):
// per (batch, head), with the state S (hd_k x hd_v, f32) carried over the
// sequence,
//   y_t = r_t . (S + diag(u) k_t^T v_t)
//   S  <- diag(w_t) S + k_t^T v_t
// and the final state returned.  The plain version is
// repro_torch/kernels/rwkv6.py::wkv_ref (the math of the reference's
// kernels/ref.wkv6_ref and models/ssm._wkv_scan).
//
// Numerics.  The state update is, per entry, one rounded product k_i v_j,
// one rounded product w_i S_ij and one rounded sum of the two, as in the
// plain version; built with --fmad=false nothing is contracted into an
// FMA, so the final state has the plain version's bits.  y is summed in
// another order: y_j = sum_i r_i S_ij + c v_j with c = sum_i r_i (u_i k_i)
// (the bonus term factored out of the sum over i), the first sum in four
// partial sums, c by a shuffle reduction over the block.
//
// Layout.  r, k, v, w, y are strided (batch, seq, head, hd) with hd
// contiguous, so the model's projections reach the kernel without a
// transpose and the reference's (BH, S, hd) layout is the case H = 1.
// u is read per (batch, head) through two strides (0 for a broadcast
// axis), so the model's (H, hd) bonus needs no broadcast copy.  s0 and sT
// are strided (batch, head, i) with j contiguous; s0 may be null (zeros),
// and sT may be s0 itself (the serving cache, updated in place): each
// thread reads its state column before it writes it, and no other thread
// touches that column.  Everything is f32.
//
// Design: one block per (batch, head), hd threads; thread j keeps state
// column S[:, j] in registers for the whole sequence.  Tokens are staged
// in chunks of 1024 / hd into shared memory (r, k, v, w; two buffers, 32
// KB): each thread copies its own column of every row with cp.async, so a
// row is one coalesced read and the next chunk's copies fly while this
// chunk's tokens are stepped.  Per chunk, the bonus dots c_t (each thread
// its column's term, reduced by warp shuffles in a fixed order), then the
// tokens in order, each thread reading r_i, w_i, k_i as broadcast float4s
// from shared memory.  Three barriers a chunk.
//
// What bounds it on an H100 (serving RWKV6-7B, hd 64, 64 heads):
// prefill, batch 8 x 1024 tokens from a zero state, reads r, k, v, w (4 x
// 134 MB) and writes y (134 MB) and the final state (8 MB): 679 MB, 0.203
// ms at 3.35 TB/s; the f32 operations, 5 hd^2 + 5 hd a token and head
// (10.9 GFLOP), take 0.163 ms at 67 TFLOP/s, so bytes bind.  A decode
// step (one token) moves the 16 KB state of each of 512 (batch, head)
// pairs in and out: 17.4 MB, 5.2 us.
// This simple kernel runs 512 blocks of 64 threads (two warps each, about
// 4 blocks an SM) and each thread issues about 5 hd unfused f32
// operations and 3 hd / 4 shared loads a token, one token after another:
// it reaches neither bound (PERF.md has its times); a faster design
// splits each state column over more threads.
// The kernel allocates nothing, launches on the caller's stream and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Args {
  const float* r; const float* k; const float* v; const float* w;
  const float* u; const float* s0; float* y; float* sT;
  int B, S, H;
  // (batch, seq, head) strides of r, k, v, w, y; (batch, head) of u;
  // (batch, head, i) of s0 and sT; in elements
  int64_t rb, rs, rh, kb, ks, kh, vb, vs, vh, wb, ws, wh;
  int64_t ub, uh, s0b, s0h, s0i, yb, ys, yh, sTb, sTh, sTi;
};

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int HD>
__global__ void __launch_bounds__(HD) wkv6_kernel(const Args a) {
  constexpr int kChunk = 1024 / HD;  // tokens a buffer holds
  constexpr int kWarps = (HD + 31) / 32;
  constexpr int kWidth = HD < 32 ? HD : 32;
  constexpr unsigned kMask = HD < 32 ? (1u << HD) - 1u : 0xffffffffu;
  // [buffer][r, k, v, w][token][i]
  __shared__ __align__(16) float buf[2][4][kChunk][HD];
  __shared__ float cpart[2][kWarps][kChunk];  // per-warp bonus partials

  const int j = threadIdx.x;
  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const float* src[4] = {
      a.r + b * a.rb + h * a.rh + j, a.k + b * a.kb + h * a.kh + j,
      a.v + b * a.vb + h * a.vh + j, a.w + b * a.wb + h * a.wh + j};
  const int64_t step[4] = {a.rs, a.ks, a.vs, a.ws};
  float* y = a.y + b * a.yb + h * a.yh + j;
  const float uj = a.u[b * a.ub + h * a.uh + j];

  // stage tokens [t0, t0 + n) into buffer `which`, this thread's column
  auto stage = [&](int t0, int which) {
    const int n = min(kChunk, a.S - t0);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      for (int t = 0; t < n; ++t)
        cp_async4(&buf[which][q][t][j], src[q] + static_cast<int64_t>(t0 + t) * step[q]);
    cp_async_commit();
  };
  stage(0, 0);

  float st[HD];  // state column j
  if (a.s0 != nullptr) {
    const float* p = a.s0 + b * a.s0b + h * a.s0h + j;
#pragma unroll
    for (int i = 0; i < HD; ++i) st[i] = p[i * a.s0i];
  } else {
#pragma unroll
    for (int i = 0; i < HD; ++i) st[i] = 0.f;
  }

  for (int t0 = 0, c = 0; t0 < a.S; t0 += kChunk, c ^= 1) {
    const int n = min(kChunk, a.S - t0);
    if (t0 + kChunk < a.S) {
      stage(t0 + kChunk, c ^ 1);  // its buffer was released by the last barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c visible to every thread
    const float (*rs_)[HD] = buf[c][0];
    const float (*ks_)[HD] = buf[c][1];
    const float (*vs_)[HD] = buf[c][2];
    const float (*ws_)[HD] = buf[c][3];
    for (int t = 0; t < n; ++t) {  // bonus dots: this column's term, reduced
      float p = rs_[t][j] * (uj * ks_[t][j]);
#pragma unroll
      for (int off = kWidth / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(kMask, p, off, kWidth);
      if ((j & 31) == 0) cpart[c][j >> 5][t] = p;
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vj = vs_[t][j];
      float cb = cpart[c][0][t];
#pragma unroll
      for (int q = 1; q < kWarps; ++q) cb += cpart[c][q][t];
      float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
      for (int i = 0; i < HD; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&rs_[t][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws_[t][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks_[t][i]);
        y0 += r4.x * st[i];
        y1 += r4.y * st[i + 1];
        y2 += r4.z * st[i + 2];
        y3 += r4.w * st[i + 3];
        st[i] = w4.x * st[i] + k4.x * vj;
        st[i + 1] = w4.y * st[i + 1] + k4.y * vj;
        st[i + 2] = w4.z * st[i + 2] + k4.z * vj;
        st[i + 3] = w4.w * st[i + 3] + k4.w * vj;
      }
      y[static_cast<int64_t>(t0 + t) * a.ys] = ((y0 + y1) + (y2 + y3)) + cb * vj;
    }
    __syncthreads();  // buffer c is free for the chunk after next
  }

  float* out = a.sT + b * a.sTb + h * a.sTh + j;
#pragma unroll
  for (int i = 0; i < HD; ++i) out[i * a.sTi] = st[i];
}

}  // namespace

extern "C" {

// Strides in elements, in the order of Args.  s0 may be null; sT may
// equal s0.  hd is 16, 32, 64 or 128.
int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* y, void* sT,
             int B, int S, int H, int hd,
             int64_t rb, int64_t rs, int64_t rh, int64_t kb, int64_t ks, int64_t kh,
             int64_t vb, int64_t vs, int64_t vh, int64_t wb, int64_t ws, int64_t wh,
             int64_t ub, int64_t uh, int64_t s0b, int64_t s0h, int64_t s0i,
             int64_t yb, int64_t ys, int64_t yh, int64_t sTb, int64_t sTh, int64_t sTi,
             void* stream) {
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(r), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(w),
               static_cast<const float*>(u), static_cast<const float*>(s0),
               static_cast<float*>(y), static_cast<float*>(sT), B, S, H,
               rb, rs, rh, kb, ks, kh, vb, vs, vh, wb, ws, wh,
               ub, uh, s0b, s0h, s0i, yb, ys, yh, sTb, sTh, sTi};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(B) * static_cast<unsigned>(H));
  switch (hd) {
    case 16: wkv6_kernel<16><<<grid, 16, 0, st>>>(a); break;
    case 32: wkv6_kernel<32><<<grid, 32, 0, st>>>(a); break;
    case 64: wkv6_kernel<64><<<grid, 64, 0, st>>>(a); break;
    case 128: wkv6_kernel<128><<<grid, 128, 0, st>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
