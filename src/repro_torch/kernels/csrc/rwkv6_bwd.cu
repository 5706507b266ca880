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
//   dr_t[i] = sum_j dy_t[j] S_{t-1}[i,j] + u[i] k_t[i] (v_t . dy_t)
//   dkv[i,j] = G_t[i,j] + r_t[i] u[i] dy_t[j]
//   dk_t[i] = sum_j dkv[i,j] v_t[j],   dv_t[j] = sum_i dkv[i,j] k_t[i]
//   dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
//   du[i]   = sum_{b,t} r_t[i] k_t[i] (v_t . dy_t)
//   ds0     = G before the first token.
//
// The recurrence is never inverted: w_t = exp(-exp(.)) underflows, so
// S_{t-1} is not (S_t - k v)/w.  The states are recomputed instead.
//   1. wkv6_bwd_states_kernel runs the forward recurrence, stores the state
//      at the start of every span of kSpan tokens in scratch, and computes
//      the forward-direction quantities: dr and the per-batch-row partial
//      sums of du.
//   2. wkv6_bwd_reverse_kernel walks the spans from the last.  A span is
//      two halves of kHalf tokens; for each half (the later first) a thread
//      recomputes the half's states from the span's start into registers,
//      then runs G backwards over them, writing dk, dw and dv (summed over
//      the block's rows), and ds0 at the end.
//   3. wkv6_bwd_reduce_kernel adds du over the batch in a fixed order (and,
//      at hd 128, dv over the row groups).  No atomics anywhere, so two runs
//      give the same bits.
//
// Numerics.  Built with --fmad=false, every product and sum rounded alone
// (__fmul_rn / __fadd_rn) as the plain version rounds them: the recomputed
// states are the forward's bits, and the elementwise G (hence ds0) is the
// plain version's bit for bit.  The sums over j (dr, dk, dw, v.dy) run in
// j order within a thread and over a fixed shuffle tree across its row's
// threads; dv sums a thread's two rows, then a fixed tree over the warp's
// row pairs, then the warps in order; the plain version's einsums take
// other orders, so those gradients are held to it within a tolerance.
//
// Layout.  r, k, v, w, dy and the outputs dr, dk, dv, dw are (B, S, H, hd)
// contiguous f32, 16-byte aligned; u is (Bu, H, hd) with Bu 1 (shared over
// the batch: du sums over b) or B; s0, dsT and ds0 are (B, H, hd, hd),
// 16-byte aligned, and may be null (zeros, zeros, not wanted).
//
// What bounds it on an H100 (RWKV6-7B training: B 8, S 1024, H 64, hd 64):
// reading r, k, v, w, dy and writing dr, dk, dv, dw moves 9 x 134 MB, 0.36
// ms at 3.35 TB/s; the 2.15e9 state entries each take ~18 f32 operations a
// token, 0.58 ms at 67 TFLOP/s (counting an FMA's two).  What the card
// issues is more: a product and a sum issue as two instructions without
// contraction, the reverse recomputes 1.5 state steps an entry, and the sums
// take shuffle trees: ~28 instructions an entry and token in the two
// passes, ~1.8 ms at one instruction a cycle on each of the 528 schedulers.
// Each block's chain of S tokens is serial, so the kernels are also bound by
// how much of each token's latency the SM's resident warps hide.
//
// Design.  One block owns all hd rows of a (b, h) (32 of 128 at hd 128).
// In the reverse kernel a thread owns a 2 x 4 tile of the state: 512
// threads at hd 64, 16 warps an SM (the first design ran 8).  It keeps a
// half-span's recomputed states in registers (8 tokens x 8 entries), where
// the first design kept 16 tokens of them in 93 KB of shared memory; the
// second half of a span is reached by recomputing its first half once more
// (24 state steps for 16 tokens).  The row sums of two tokens (dk and dw
// of two rows each) fold over the row's threads in one transpose-reduce
// tree, 8 shuffles at hd 64 for the pair where the first design spent 25 a
// token.  dv's sum over rows finishes in the block: the row pairs of a warp
// fold their columns, the warps' partials meet in shared memory and are
// added in order while the next span computes, so the dv partial buffer of
// the first design (4 x 134 MB written and read back) is gone at hd <= 64.
// The states pass gives a thread a 4 x 4 tile (256 threads at hd 64, four
// blocks an SM), so that a token's fold of dr and v.dy, its dr store and du
// spread over 16 entries.  Every full span or half is unrolled without a
// bound check on each token, so the compiler overlaps one token's shuffle
// tree with the next token's arithmetic.  A span's r, k, w, v and dy rows
// and the thread's start state are staged with cp.async into a double
// buffer while the previous span computes: one barrier a span, where the
// first design's own loads stalled the chain twice a chunk.  The
// chunk-start scratch keeps its stride of 16 tokens (537 MB at the training
// shape; at hd 128 its stride grows from 8 to 16, halving it).
//
// Times at the training shape (PERF.md §6, tools/bwd_ab.py, NVIDIA H100
// 80GB HBM3 at 700 W): 2.78 ms (states 0.84, reverse 1.90, reduce 0.002),
// against the first design's 7.15-7.21 ms (1.91-1.97, 4.93-5.02, 0.22).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSpan = 16;  // tokens between stored chunk-start states
constexpr int kHalf = 8;   // tokens whose states a thread keeps in registers

// a compile-time flag for the generic lambdas that unroll a whole span or
// half without a bound check on each token
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

template <int HD>
struct Tile {
  // a thread owns rows 2 rp, 2 rp + 1 and columns 4 cg .. 4 cg + 3
  static constexpr int kThreads = HD * HD / 8 < 512 ? HD * HD / 8 : 512;
  static constexpr int kRows = kThreads * 8 / HD;  // state rows a block
  static constexpr int kGroups = HD / kRows;       // blocks a (b, h): 1, or 4 at hd 128
  static constexpr int kTpr = HD / 4;              // threads of a row pair: 4 .. 32
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kTok = 3 * kRows + 2 * HD;  // a staged token: r, k, w, v, dy
  static constexpr int kStageFloats = 2 * kSpan * kTok;
  static constexpr int kStatesSmem = kStageFloats * 4;
  static constexpr int kStartFloats = 2 * 2 * kThreads * 4;  // two spans' start states
  // where a block holds all rows (hd <= 64), two spans' warp dv partials, so
  // that a span's dv goes out while the next span computes; at hd 128 one
  // (two would not fit in shared memory)
  static constexpr bool kOverlap = kGroups == 1;
  static constexpr int kDvFloats = (kOverlap ? 2 : 1) * kSpan * kWarps * HD;
  static constexpr int kReverseSmem = (kStageFloats + kDvFloats + kStartFloats) * 4;
};

struct Args {
  const float *r, *k, *v, *w, *u, *s0, *dy, *dsT;
  float *dr, *dk, *dv, *dw, *du, *ds0;
  float *states, *dv_part, *du_part;
  int B, S, H, u_batched;
};

// Fold N values a lane over the xor offsets O, O/2, ..., LO: while a lane
// holds more than one value, it keeps one half (the upper half where the
// offset's bit is set) and adds its partner's copy of that half; once one
// is left, the remaining offsets add the partner's value.  A fixed tree:
// the same bits every run.
template <int N, int O, int LO>
__device__ __forceinline__ void fold(float* v, int lane) {
  if constexpr (O >= LO && O > 0) {
    if constexpr (N > 1) {
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int q = 0; q < N / 2; ++q) {
        const float send = up ? v[q] : v[q + N / 2];
        const float keep = up ? v[q + N / 2] : v[q];
        v[q] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, O));
      }
      fold<N / 2, O / 2, LO>(v, lane);
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(kFull, v[0], O));
      fold<1, O / 2, LO>(v, lane);
    }
  }
}

// the index of the first value a lane holds after fold<N, O, LO>
template <int N, int O, int LO>
__device__ __forceinline__ int fold_index(int lane) {
  if constexpr (N > 1 && O >= LO && O > 0) {
    return ((lane & O) ? N / 2 : 0) + fold_index<N / 2, O / 2, LO>(lane);
  } else {
    return 0;
  }
}

// the values a lane holds after fold<N, O, LO>
template <int N, int O, int LO>
__host__ __device__ constexpr int fold_left() {
  if constexpr (N > 1 && O >= LO && O > 0) {
    return fold_left<N / 2, O / 2, LO>();
  } else {
    return N;
  }
}

// whether the lane is the first of those holding the same sums after
// fold<N, O, LO> (its bits of the offsets that only add are clear)
template <int N, int O, int LO>
__device__ __forceinline__ bool fold_first(int lane) {
  if constexpr (O >= LO && O > 0) {
    if constexpr (N > 1) {
      return fold_first<N / 2, O / 2, LO>(lane);
    } else {
      return (lane & O) == 0 && fold_first<1, O / 2, LO>(lane);
    }
  } else {
    return true;
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage tokens t0 .. t0 + n - 1 of the block's (b, h) into buf ([kSpan][kTok]:
// r, k, w of the block's rows, then v and dy) with 16-byte cp.async copies,
// and, given st (the thread's tile of the span's start state in scratch),
// the thread's two rows of it into sst ([2][NT][4]), as one commit group;
// NT threads copy.
template <int HD, int NT>
__device__ __forceinline__ void stage(const Args& a, float* buf, int64_t base, int rowoff, int t0,
                                      int n, float* sst = nullptr, const float* st = nullptr) {
  using T = Tile<HD>;
  constexpr int Q = T::kTok / 4, R = T::kRows;
  const int64_t tok = static_cast<int64_t>(a.H) * HD;
  for (int q = threadIdx.x; q < n * Q; q += NT) {
    const int tt = q / Q, f = 4 * (q % Q);
    const int64_t at = base + (t0 + tt) * tok;
    const float* src;
    if (f < R) src = a.r + at + rowoff + f;
    else if (f < 2 * R) src = a.k + at + rowoff + f - R;
    else if (f < 3 * R) src = a.w + at + rowoff + f - 2 * R;
    else if (f < 3 * R + HD) src = a.v + at + f - 3 * R;
    else src = a.dy + at + f - 3 * R - HD;
    cp_async16(buf + tt * T::kTok + f, src);
  }
  if (st != nullptr) {
    cp_async16(sst + 4 * threadIdx.x, st);
    cp_async16(sst + 4 * (NT + threadIdx.x), st + HD);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void load_rows(float (&x)[2][4], const float* p, int hd) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + hd);
  x[0][0] = a.x, x[0][1] = a.y, x[0][2] = a.z, x[0][3] = a.w;
  x[1][0] = b.x, x[1][1] = b.y, x[1][2] = b.z, x[1][3] = b.w;
}

__device__ __forceinline__ void store_rows(float* p, const float (&x)[2][4], int hd) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0][0], x[0][1], x[0][2], x[0][3]);
  *reinterpret_cast<float4*>(p + hd) = make_float4(x[1][0], x[1][1], x[1][2], x[1][3]);
}

// one token of the forward recurrence on a thread's tile
__device__ __forceinline__ void step(float (&S)[2][4], float2 k2, float2 w2, float4 v4) {
  const float kq[2] = {k2.x, k2.y}, wq[2] = {w2.x, w2.y}, ve[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) S[q][e] = __fadd_rn(__fmul_rn(wq[q], S[q][e]), __fmul_rn(kq[q], ve[e]));
  }
}

// the states pass's thread tile: TR rows x 4 columns (4 rows where a block
// of them still fills a warp), so that a token's fixed costs (the row fold,
// dr's store, du) spread over more state entries
template <int HD>
struct StatesTile {
  static constexpr int kTR = HD >= 32 ? 4 : 2;
  static constexpr int kThreads = Tile<HD>::kRows / kTR * (HD / 4);
};

template <int HD>
__global__ void __launch_bounds__(StatesTile<HD>::kThreads, 4) wkv6_bwd_states_kernel(const Args a) {
  using T = Tile<HD>;
  constexpr int R = T::kRows, TPR = T::kTpr, TR = StatesTile<HD>::kTR;
  constexpr int NT = StatesTile<HD>::kThreads, N = 2 * TR;
  extern __shared__ float4 smem4[];
  float* sbuf = reinterpret_cast<float*>(smem4);  // [2][kSpan][kTok]
  const int tid = threadIdx.x, lane = tid & 31;
  const int rg = tid / TPR, cg = tid % TPR, j0 = 4 * cg;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int rowoff = blockIdx.y * R, i0 = rowoff + TR * rg;
  const int64_t tok = static_cast<int64_t>(a.H) * HD;
  const int64_t base = static_cast<int64_t>(b) * a.S * tok + static_cast<int64_t>(h) * HD;
  // after the row fold a lane holds dr of row idx (idx < TR) or v.dy
  const int idx = fold_index<N, TPR / 2, 1>(lane);
  const bool writer = idx < TR && fold_first<N, TPR / 2, 1>(lane);
  const int me = idx < TR ? idx : TR - 1;                // the row whose dr and du the lane carries
  const int vsrc = (lane & ~(TPR - 1)) + TPR / 2;        // a lane holding v.dy
  const float ui = a.u[(static_cast<int64_t>(a.u_batched ? b : 0) * a.H + h) * HD + i0 + me];
  float S[TR][4];
#pragma unroll
  for (int q = 0; q < TR; ++q) {
    if (a.s0 != nullptr) {
      const float4 s4 = *reinterpret_cast<const float4*>(
          a.s0 + (static_cast<int64_t>(bh) * HD + i0 + q) * HD + j0);
      S[q][0] = s4.x, S[q][1] = s4.y, S[q][2] = s4.z, S[q][3] = s4.w;
    } else {
      S[q][0] = S[q][1] = S[q][2] = S[q][3] = 0.f;
    }
  }
  float du_acc = 0.f;
  const int nc = (a.S + kSpan - 1) / kSpan;
  stage<HD, NT>(a, sbuf, base, rowoff, 0, min(kSpan, a.S));
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * kSpan, n = min(kSpan, a.S - t0);
    const float* cur = sbuf + (c & 1) * kSpan * T::kTok;
#pragma unroll
    for (int q = 0; q < TR; ++q)
      *reinterpret_cast<float4*>(
          a.states + ((static_cast<int64_t>(bh) * nc + c) * HD + i0 + q) * HD + j0) =
          make_float4(S[q][0], S[q][1], S[q][2], S[q][3]);
    cp_async_wait_all();
    __syncthreads();  // span c is staged; every thread is done with span c - 1's buffer
    if (c + 1 < nc) stage<HD, NT>(a, sbuf + ((c + 1) & 1) * kSpan * T::kTok, base, rowoff,
                                  t0 + kSpan, min(kSpan, a.S - t0 - kSpan));
    // a whole span unrolled without a bound check on each token, so that the
    // compiler can overlap one token's shuffle tree with the next token's work
    auto run_span = [&](auto full) {
#pragma unroll
      for (int tt = 0; tt < kSpan; ++tt) {
        if (decltype(full)::value || tt < n) {
          const float* tk = cur + tt * T::kTok;
          float kq[TR], wq[TR];
#pragma unroll
          for (int q = 0; q < TR; ++q) kq[q] = tk[R + TR * rg + q], wq[q] = tk[2 * R + TR * rg + q];
          const float4 v4 = *reinterpret_cast<const float4*>(tk + 3 * R + j0);
          const float4 d4 = *reinterpret_cast<const float4*>(tk + 3 * R + HD + j0);
          const float ve[4] = {v4.x, v4.y, v4.z, v4.w}, de[4] = {d4.x, d4.y, d4.z, d4.w};
          float vals[N];
#pragma unroll
          for (int q = 0; q < TR; ++q) {
            float part = 0.f;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              part = __fadd_rn(part, __fmul_rn(de[e], S[q][e]));
              S[q][e] = __fadd_rn(__fmul_rn(wq[q], S[q][e]), __fmul_rn(kq[q], ve[e]));
            }
            vals[q] = part;
          }
          float vdy = 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) vdy = __fadd_rn(vdy, __fmul_rn(ve[e], de[e]));
#pragma unroll
          for (int q = TR; q < N; ++q) vals[q] = vdy;
          fold<N, TPR / 2, 1>(vals, lane);
          const float vd = __shfl_sync(kFull, vals[0], vsrc);
          const float rm = tk[TR * rg + me], km = tk[R + TR * rg + me];
          du_acc = __fadd_rn(du_acc, __fmul_rn(__fmul_rn(rm, km), vd));
          if (writer)
            a.dr[base + (t0 + tt) * tok + i0 + idx] =
                __fadd_rn(vals[0], __fmul_rn(__fmul_rn(ui, km), vd));
        }
      }
    };
    if (n == kSpan) run_span(Flag<true>());
    else run_span(Flag<false>());
  }
  if (writer) a.du_part[(static_cast<int64_t>(b) * a.H + h) * HD + i0 + idx] = du_acc;
}

template <int HD>
__global__ void __launch_bounds__(Tile<HD>::kThreads, 1) wkv6_bwd_reverse_kernel(const Args a) {
  using T = Tile<HD>;
  constexpr int R = T::kRows, TPR = T::kTpr, NW = T::kWarps, NT = T::kThreads;
  constexpr int NR = fold_left<8, TPR / 2, 1>();  // dk / dw values a lane holds after its fold
  constexpr int NV = fold_left<8, 16, TPR>();     // dv values a lane holds after its fold
  extern __shared__ float4 smem4[];
  float* sbuf = reinterpret_cast<float*>(smem4);  // [2][kSpan][kTok]
  float* sdv = sbuf + T::kStageFloats;             // [1 or 2][kSpan][NW][HD]: each warp's dv
  float* sst = sdv + T::kDvFloats;                 // [2][2][NT][4]: the spans' start states
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rp = tid / TPR, cg = tid % TPR, j0 = 4 * cg;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int rowoff = blockIdx.y * R, i0 = rowoff + 2 * rp;
  const int64_t tok = static_cast<int64_t>(a.H) * HD;
  const int64_t base = static_cast<int64_t>(b) * a.S * tok + static_cast<int64_t>(h) * HD;
  const int64_t srow = (static_cast<int64_t>(bh) * HD + i0) * HD + j0;
  const int64_t total = static_cast<int64_t>(a.B) * a.S * tok;
  const float* up = a.u + (static_cast<int64_t>(a.u_batched ? b : 0) * a.H + h) * HD + i0;
  const float uq[2] = {up[0], up[1]};
  const int ridx = fold_index<8, TPR / 2, 1>(lane);  // the first of the NR values held
  const bool row_writer = fold_first<8, TPR / 2, 1>(lane);
  const int cidx = fold_index<8, 16, TPR>(lane);  // the first of the NV values held
  const bool col_writer = fold_first<8, 16, TPR>(lane);
  float G[2][4];
  if (a.dsT != nullptr) {
    load_rows(G, a.dsT + srow, HD);
  } else {
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) G[q][e] = 0.f;
  }
  const int nc = (a.S + kSpan - 1) / kSpan;
  const float* states = a.states + (static_cast<int64_t>(bh) * nc * HD + i0) * HD + j0;
  constexpr int64_t kStride = static_cast<int64_t>(HD) * HD;  // one span's states
  stage<HD, NT>(a, sbuf, base, rowoff, (nc - 1) * kSpan, a.S - (nc - 1) * kSpan, sst,
            states + (nc - 1) * kStride);
  // span cc's dv from the warps' partials in buffer pb, the warps in order
  auto flush = [&](int cc, int pb) {
    const int tc0 = cc * kSpan, tn = min(kSpan, a.S - tc0);
    const float* sd = sdv + pb * kSpan * NW * HD;
    for (int q = tid; q < tn * HD; q += NT) {
      const int tt = q / HD, j = q % HD;
      float sum = 0.f;
#pragma unroll
      for (int wp = 0; wp < NW; ++wp) sum = __fadd_rn(sum, sd[(tt * NW + wp) * HD + j]);
      const int64_t off = base + (tc0 + tt) * tok + j;
      if (T::kGroups == 1) a.dv[off] = sum;
      else a.dv_part[blockIdx.y * total + off] = sum;
    }
  };
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kSpan, n = min(kSpan, a.S - t0), bi = (nc - 1 - c) & 1;
    const int db = T::kOverlap ? bi : 0;  // the dv partials' buffer
    const float* cur = sbuf + bi * kSpan * T::kTok;
    const float* start = sst + bi * 2 * NT * 4 + 4 * tid;
    cp_async_wait_all();
    __syncthreads();  // span c is staged; span c + 1's reads of the other buffers are done
    if (c > 0) stage<HD, NT>(a, sbuf + (bi ^ 1) * kSpan * T::kTok, base, rowoff, t0 - kSpan, kSpan,
                         sst + (bi ^ 1) * 2 * NT * 4, states + (c - 1) * kStride);
    // span c + 1's dv goes out while this span computes
    if (T::kOverlap && c + 1 < nc) flush(c + 1, bi ^ 1);
    for (int half = n > kHalf ? 1 : 0; half >= 0; --half) {
      const int h0 = half * kHalf, m = min(kHalf, n - h0);
      float S[2][4];
      load_rows(S, start, 4 * NT);
      if (half == 1) {
#pragma unroll
        for (int tt = 0; tt < kHalf; ++tt) {
          const float* tk = cur + tt * T::kTok;
          step(S, *reinterpret_cast<const float2*>(tk + R + 2 * rp),
               *reinterpret_cast<const float2*>(tk + 2 * R + 2 * rp),
               *reinterpret_cast<const float4*>(tk + 3 * R + j0));
        }
      }
      // a whole half unrolled without a bound check on each token (the
      // compiler then overlaps tokens); the last span's halves check
      auto run_half = [&](auto full) {
        constexpr bool F = decltype(full)::value;
        // the half's states S_{t-1}, recomputed from the span's start
        float sp[kHalf][2][4];
#pragma unroll
        for (int tt = 0; tt < kHalf; ++tt) {
          if (F || tt < m) {
#pragma unroll
            for (int q = 0; q < 2; ++q)
#pragma unroll
              for (int e = 0; e < 4; ++e) sp[tt][q][e] = S[q][e];
            if (tt + 1 < (F ? kHalf : m)) {
              const float* tk = cur + (h0 + tt) * T::kTok;
              step(S, *reinterpret_cast<const float2*>(tk + R + 2 * rp),
                   *reinterpret_cast<const float2*>(tk + 2 * R + 2 * rp),
                   *reinterpret_cast<const float4*>(tk + 3 * R + j0));
            }
          }
        }
        // tokens in pairs, the later first: one fold tree for both tokens' sums
#pragma unroll
        for (int p = kHalf / 2 - 1; p >= 0; --p) {
          float vals[8], col[8];  // [dk rows, dw rows] and dv columns of tokens 2p, 2p + 1
#pragma unroll
          for (int k = 1; k >= 0; --k) {
            const int tt = 2 * p + k;
            if (F || tt < m) {
              const float* tk = cur + (h0 + tt) * T::kTok;
              const float2 r2 = *reinterpret_cast<const float2*>(tk + 2 * rp);
              const float2 k2 = *reinterpret_cast<const float2*>(tk + R + 2 * rp);
              const float2 w2 = *reinterpret_cast<const float2*>(tk + 2 * R + 2 * rp);
              const float4 v4 = *reinterpret_cast<const float4*>(tk + 3 * R + j0);
              const float4 d4 = *reinterpret_cast<const float4*>(tk + 3 * R + HD + j0);
              const float rq[2] = {r2.x, r2.y}, kq[2] = {k2.x, k2.y}, wq[2] = {w2.x, w2.y};
              const float ve[4] = {v4.x, v4.y, v4.z, v4.w}, de[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                const float ru = __fmul_rn(rq[q], uq[q]);
                float pk = 0.f, pw = 0.f;
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const float dkv = __fadd_rn(G[q][e], __fmul_rn(ru, de[e]));
                  pk = __fadd_rn(pk, __fmul_rn(dkv, ve[e]));
                  pw = __fadd_rn(pw, __fmul_rn(G[q][e], sp[tt][q][e]));
                  const float cv = __fmul_rn(dkv, kq[q]);
                  col[4 * k + e] = q == 0 ? cv : __fadd_rn(col[4 * k + e], cv);
                  G[q][e] = __fadd_rn(__fmul_rn(wq[q], G[q][e]), __fmul_rn(rq[q], de[e]));
                }
                vals[4 * k + q] = pk;
                vals[4 * k + 2 + q] = pw;
              }
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) vals[4 * k + e] = col[4 * k + e] = 0.f;
            }
          }
          // dk and dw over the row's threads: value q is token q >> 2's dk
          // (bit 1 of q clear) or dw of row q & 1
          fold<8, TPR / 2, 1>(vals, lane);
          if (row_writer) {
#pragma unroll
            for (int j = 0; j < NR; ++j) {
              const int q = ridx + j, tt = 2 * p + (q >> 2);
              if (F || tt < m) {
                const int64_t off = base + (t0 + h0 + tt) * tok + i0 + (q & 1);
                if (q & 2) a.dw[off] = vals[j];
                else a.dk[off] = vals[j];
              }
            }
          }
          // dv over the warp's row pairs: value q is token q >> 2's column q & 3
          fold<8, 16, TPR>(col, lane);
          if (col_writer) {
#pragma unroll
            for (int j = 0; j < NV; ++j) {
              const int q = cidx + j, tt = 2 * p + (q >> 2);
              if (F || tt < m)
                sdv[((db * kSpan + h0 + tt) * NW + warp) * HD + j0 + (q & 3)] = col[j];
            }
          }
        }
      };
      if (m == kHalf) run_half(Flag<true>());
      else run_half(Flag<false>());
    }
    if (!T::kOverlap) {
      __syncthreads();  // the warps' dv partials of span c are in sdv
      flush(c, 0);
    }
  }
  if (T::kOverlap) {
    __syncthreads();  // the first span's dv partials are in buffer (nc - 1) & 1
    flush(0, (nc - 1) & 1);
  }
  if (a.ds0 != nullptr) store_rows(a.ds0 + srow, G, HD);
}

// du: the batch rows' partials added in order (or copied, for a per-batch-row
// u); dv, where a (b, h) spans several blocks: the row groups' partials in
// order
__global__ void wkv6_bwd_reduce_kernel(const Args a, int hd, int groups) {
  const int64_t hh = static_cast<int64_t>(a.H) * hd;
  const int64_t n1 = a.u_batched ? a.B * hh : hh;
  const int64_t n2 = groups > 1 ? static_cast<int64_t>(a.B) * a.S * hh : 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; q < n1 + n2;
       q += stride) {
    if (q < n1) {
      if (a.u_batched) {
        a.du[q] = a.du_part[q];
      } else {
        float s = 0.f;
        for (int bb = 0; bb < a.B; ++bb) s = __fadd_rn(s, a.du_part[bb * hh + q]);
        a.du[q] = s;
      }
    } else {
      const int64_t p = q - n1;
      float s = 0.f;
      for (int g = 0; g < groups; ++g) s = __fadd_rn(s, a.dv_part[g * n2 + p]);
      a.dv[p] = s;
    }
  }
}

template <typename K>
cudaError_t allow_smem(K* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HD>
cudaError_t run(const Args& a, cudaStream_t st) {
  using T = Tile<HD>;
  static bool sized = false;  // once an instantiation: the call may be in a graph capture
  cudaError_t err;
  if (!sized) {
    err = allow_smem(wkv6_bwd_states_kernel<HD>, T::kStatesSmem);
    if (err != cudaSuccess) return err;
    err = allow_smem(wkv6_bwd_reverse_kernel<HD>, T::kReverseSmem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const dim3 grid(a.B * a.H, T::kGroups);
  wkv6_bwd_states_kernel<HD><<<grid, StatesTile<HD>::kThreads, T::kStatesSmem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_bwd_reverse_kernel<HD><<<grid, T::kThreads, T::kReverseSmem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = static_cast<int64_t>(a.B) * a.H * HD * (T::kGroups > 1 ? a.S + 1 : 1);
  const int blocks = static_cast<int>(n / 256 + 1 < 132 * 16 ? n / 256 + 1 : 132 * 16);
  wkv6_bwd_reduce_kernel<<<blocks, 256, 0, st>>>(a, HD, T::kGroups);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tokens between the stored chunk-start states at head dim hd (0: hd not
// built).  The caller sizes the scratch with it and wkv6_bwd_groups: states
// B H ceil(S / chunk) hd hd floats, du partials B H hd floats.
int wkv6_bwd_chunk(int hd) {
  switch (hd) {
    case 16: case 32: case 64: case 128: return kSpan;
    default: return 0;
  }
}

// Blocks a (b, h) at head dim hd (0: hd not built).  Above 1 the caller
// also gives dv partials, groups B S H hd floats; at 1, dv_part may be null.
int wkv6_bwd_groups(int hd) {
  switch (hd) {
    case 16: return Tile<16>::kGroups;
    case 32: return Tile<32>::kGroups;
    case 64: return Tile<64>::kGroups;
    case 128: return Tile<128>::kGroups;
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
