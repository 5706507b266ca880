// Hand-written Hopper (sm_90a) kernels of the RWKV-6 (Finch) WKV recurrence.
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
// Numerics.  Each state entry is updated as S = fl(fl(w_i S_ij) +
// fl(k_i v_j)): one rounded product, another, one rounded sum, written
// with __fmul_rn / __fadd_rn (and built with --fmad=false), so the final
// state has the plain version's bits.  No FMA may touch the state: an FMA
// rounds w S + k v once instead of three times, and the difference would
// carry through the recurrence away from the plain version's bits.  y is
// held only within a tolerance, so it is summed in another order, with
// one FMA an entry: y_j = sum_i r_i S_ij + c v_j, c = sum_i r_i (u_i k_i)
// (the bonus term factored out of the sum over i).
//
// Layout.  r, k, v, w, y are strided (batch, seq, head, hd) with hd
// contiguous, so the model's projections reach the kernel without a
// transpose and the reference's (BH, S, hd) layout is the case H = 1.
// u is read per (batch, head) through two strides (0 for a broadcast
// axis), so the model's (H, hd) bonus needs no broadcast copy.  s0 and sT
// are strided (batch, head, i) with j contiguous; s0 may be null (zeros),
// and sT may be s0 itself (the serving cache, updated in place): each
// thread reads its state tile before it writes it, and no other thread
// touches that tile.  Everything is f32.  Where every pointer is 16-byte
// aligned and every stride a multiple of 4 (the model's tensors), rows
// move as 16-byte vectors; otherwise the same kernels move 4 bytes at a
// time.
//
// Design: the state in register tiles.  One block per (batch, head) of
// (hd / TR) x (hd / 4) threads; thread (g, c) owns the TR x 4 tile of S at
// rows g TR .. g TR + TR - 1, columns 4c .. 4c + 3 (hd 64: 8 x 4 tiles over
// 128 threads, 32 state floats a thread, for a prefill; 4 x 4 over 256
// for a decode step).  The column group c is the fast thread index: the
// eight lanes of a quarter warp share their rows, so each r, w, k shared
// load is one broadcast address, and a warp's state loads and stores
// cover whole rows.  y's sum over i is reduced in a fixed order: within
// a warp by shuffles over the row groups it holds (halving exchanges that
// leave each lane some of its four columns), then across warps through
// shared memory, in warp order.
//   * Prefill (S > 1): tokens are staged in chunks (16 tokens at hd 64;
//     r, k, v, w rows of hd floats by 16-byte cp.async into a ring of two
//     buffers, so the next chunk's copies fly while this one is stepped;
//     two barriers a chunk).  Per chunk the bonus dots c_t of all its
//     tokens at once; per token each thread reads r, w, k of its rows and
//     v of its columns as float4s from shared memory (half a tile ahead:
//     the second half of its rows while the first is updated, the next
//     token's first half while the second is), adds r_i S_ij over its rows
//     into four column sums, updates its 4 TR entries, and reduces the
//     last token's column sums over the warp into a per-warp buffer; one
//     pass a chunk adds the warps' sums and c_t v_j and writes the chunk's
//     y rows as coalesced 16-byte stores.
//   * Decode (S == 1): no staging, one barrier.  Each thread loads its
//     state tile as float4s, all in flight together, its r, w, k, u and v
//     values straight from device memory (256 B a row, served by L1 and
//     L2), folds its rows' share of the bonus into its column sums,
//     updates the tile, writes it back, and y is reduced as above.  No
//     host sync, so a CUDA graph captures it.
//
// What bounds it on an H100 (serving RWKV6-7B, hd 64, 64 heads):
// prefill, batch 8 x 1024 tokens from a zero state, reads r, k, v, w (4 x
// 134 MB) and writes y (134 MB) and the final state (8 MB): 679 MB, 0.203
// ms at 3.35 TB/s.  Exact state bits cost more than that: 8 x 1024 x 64 x
// 64^2 = 2.15e9 entry updates of 3 unfused f32 instructions, plus one FMA
// for y, are 8.6e9 f32 instructions; at 128 lanes x 132 SMs x 1.98 GHz
// that is 0.257 ms (0.321 ms with y unfused), an issue floor above the
// bytes bound.  (The data-sheet 67 TFLOP/s counts an FMA as two
// operations; the exact recurrence cannot use it.)  On top come, a token
// and thread, the shared loads of r, w, k, v (the shared-memory port
// delivers 128 B a cycle to an SM, so at one float a state entry they
// would cost as many cycles as the f32 work; the quarter-warp broadcast
// of r, w, k halves that), the shuffles and the loop, and once a chunk
// the staging, the bonus dots and the y pass: PERF.md has what each
// costs.
// A decode step (one token) moves the 16 KB state of each of 512 (batch,
// head) pairs in and out: 17.4 MB, 5.2 us; it issues little, so it aims
// at the bytes.
// Tensor cores are not used: the chunked matrix form of the recurrence
// ("chunk" WKV) rescales the state by exp(-sum log w), which overflows for
// fast-decay channels and rounds the state differently from the per-token
// recurrence (the reference's docstring rejects it for that reason).
// The kernels allocate nothing, launch on the caller's stream and return
// cudaGetLastError().

#include <cstdint>
#include <initializer_list>
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

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

constexpr int TC = 4;  // columns of a state tile: one float4 of a row

// The tile of a (head dim, rows) instantiation.  Thread (g, c) = (tid /
// NC, tid % NC) owns rows g TR .. g TR + TR - 1, columns c TC .. c TC + 3.
template <int HD, int TR>
struct Tile {
  static constexpr int kCols = HD / TC;            // column groups NC
  static constexpr int kGroups = HD / TR;          // row groups G
  static constexpr int kThreads = kGroups * kCols;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kWarpRows = 32 / kCols;      // row groups a warp holds
  // tokens a staging chunk holds: the ring (8 rows of hd a token) and the
  // warps' column sums (one row each) in at most 56 KB, so four blocks fit
  // an SM; a power of two, at most 1024 / hd
  static constexpr int kChunk0 = 14336 / ((8 + kWarps) * HD);
  static constexpr int kChunk = kChunk0 >= 1024 / HD ? 1024 / HD : kChunk0 >= 32 ? 32
                              : kChunk0 >= 16 ? 16 : kChunk0 >= 8 ? 8 : 4;
  static constexpr int kSmem = (8 * kChunk * HD + kWarps * (kChunk + 1) * HD + kChunk) * 4;
  // blocks an SM must hold: four (528 slots hold the serving path's 512
  // (batch, head) blocks in one wave) where four state registers an entry
  // allow it, fewer otherwise (the register cap: 64 for the 4 x 4 tile at
  // hd 64, 128 for 8 x 4)
  static constexpr int kMinBlocks0 = 65536 / (kThreads * 4 * TR * TC);
  static constexpr int kMinBlocks = kMinBlocks0 < 1 ? 1 : (kMinBlocks0 > 4 ? 4 : kMinBlocks0);
  static_assert(kCols <= 32 && 32 % kCols == 0 && kGroups % kWarpRows == 0,
                "a warp holds whole rows of column groups");
  static_assert(TR == 2 || TR % 4 == 0, "rows a tile: 2 or a multiple of 4");
  static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps, at most 1024");
};

// The columns a lane keeps after reduce_warp_rows: W row-group lanes of a
// warp share a column group; the halving exchanges span min(W, 4) of
// them, each leaving the lane whose bit of its row index gl is set the
// upper half of what is left.
template <int W>
struct Kept {
  static constexpr int kLanes = W < TC ? W : TC;
  static constexpr int kCount = TC / kLanes;       // columns a lane keeps
  static __device__ __forceinline__ int offset(int gl) {  // its first
    int o = 0;
#pragma unroll
    for (int half = TC / 2, bit = 1; half >= 1 && bit < W; half >>= 1, bit <<= 1)
      if (gl & bit) o += half;
    return o;
  }
};

// The four column sums of a lane, reduced over the W row-group lanes of
// its warp that share its columns (lane offsets NC, 2 NC, ...), in a fixed
// order: halving exchanges, then a butterfly over the row groups left.
// p[0 .. Kept<W>::kCount) then holds the kept columns' sums.
template <int NC, int W>
__device__ __forceinline__ void reduce_warp_rows(float (&p)[TC], int gl) {
#pragma unroll
  for (int half = TC / 2, bit = 1; half >= 1 && bit < W; half >>= 1, bit <<= 1) {
    const bool hi = gl & bit;
#pragma unroll
    for (int q = 0; q < half; ++q) {
      const float keep = hi ? p[q + half] : p[q];
      const float send = hi ? p[q] : p[q + half];
      p[q] = keep + __shfl_xor_sync(0xffffffffu, send, bit * NC);
    }
  }
#pragma unroll
  for (int bit = TC; bit < W; bit <<= 1) p[0] += __shfl_xor_sync(0xffffffffu, p[0], bit * NC);
}

// N consecutive floats from device memory (16-byte vectors when vec).
template <int N>
__device__ __forceinline__ void load_row(float (&x)[N], const float* p, bool vec) {
  if (N % 4 == 0 && vec) {
#pragma unroll
    for (int a = 0; a + 3 < N; a += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + a);
      x[a] = q.x; x[a + 1] = q.y; x[a + 2] = q.z; x[a + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int a = 0; a < N; ++a) x[a] = p[a];
  }
}

// The state tile: rows i0 .. i0 + TR - 1 of (batch b, head h), columns
// j0 .. j0 + 3.
template <int TR>
__device__ __forceinline__ void load_tile(float (&st)[TR][TC], const Args& a, int b, int h,
                                          int i0, int j0, bool vec) {
  if (a.s0 == nullptr) {
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int q = 0; q < TC; ++q) st[i][q] = 0.f;
    return;
  }
  const float* p = a.s0 + b * a.s0b + h * a.s0h + static_cast<int64_t>(i0) * a.s0i + j0;
#pragma unroll
  for (int i = 0; i < TR; ++i) load_row<TC>(st[i], p + i * a.s0i, vec);
}

template <int TR>
__device__ __forceinline__ void store_tile(const float (&st)[TR][TC], const Args& a, int b,
                                           int h, int i0, int j0, bool vec) {
  float* p = a.sT + b * a.sTb + h * a.sTh + static_cast<int64_t>(i0) * a.sTi + j0;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    float* o = p + i * a.sTi;
    if (vec) {
      *reinterpret_cast<float4*>(o) = make_float4(st[i][0], st[i][1], st[i][2], st[i][3]);
    } else {
#pragma unroll
      for (int q = 0; q < TC; ++q) o[q] = st[i][q];
    }
  }
}

// One token's step of a thread's tile: the column sums of r_i S_ij over
// its rows (one FMA an entry, the state before the update), then the
// update S = fl(fl(w_i S_ij) + fl(k_i v_j)).
template <int TR>
__device__ __forceinline__ void step_tile(float (&st)[TR][TC], float (&p)[TC],
                                          const float (&r)[TR], const float (&w)[TR],
                                          const float (&k)[TR], const float (&v)[TC]) {
#pragma unroll
  for (int i = 0; i < TR; ++i) {
#pragma unroll
    for (int q = 0; q < TC; ++q) {
      p[q] = __fmaf_rn(r[i], st[i][q], p[q]);
      st[i][q] = __fadd_rn(__fmul_rn(w[i], st[i][q]), __fmul_rn(k[i], v[q]));
    }
  }
}

// Shared loads by 32-bit shared-window address.
__device__ __forceinline__ float4 lds4(uint32_t a) {
  float4 x;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w) : "r"(a));
  return x;
}
__device__ __forceinline__ float lds1(uint32_t a) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(a));
  return x;
}
__device__ __forceinline__ float2 lds2(uint32_t a) {
  float2 x;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(x.x), "=f"(x.y) : "r"(a));
  return x;
}
__device__ __forceinline__ void sts4(uint32_t a, float x, float y, float z, float w) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "f"(x), "f"(y), "f"(z),
               "f"(w));
}
__device__ __forceinline__ void sts2(uint32_t a, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(a), "f"(x), "f"(y));
}
__device__ __forceinline__ void sts1(uint32_t a, float x) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(a), "f"(x));
}
template <int N>
__device__ __forceinline__ void lds_row(float (&x)[N], uint32_t a) {
  if constexpr (N == 1) {
    x[0] = lds1(a);
  } else if constexpr (N == 2) {
    const float2 q = lds2(a);
    x[0] = q.x; x[1] = q.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 q = lds4(a + 4 * i);
      x[i] = q.x; x[i + 1] = q.y; x[i + 2] = q.z; x[i + 3] = q.w;
    }
  }
}

// N rows' r, w, k of a token from a staged chunk [r, k, v, w][token][i]
// of A floats an array (one address a quarter warp); ra: the shared
// address of r[t][first row].
template <int N>
struct Rows {
  float r[N], w[N], k[N];
  template <int A>
  __device__ __forceinline__ void load(uint32_t ra) {
    lds_row<N>(r, ra);
    lds_row<N>(k, ra + 4 * A);
    lds_row<N>(w, ra + 12 * A);
  }
};

// step_tile on rows I0 .. I0 + N - 1 of a thread's tile.
template <int I0, int N, int TR>
__device__ __forceinline__ void step_rows(float (&st)[TR][TC], float (&p)[TC],
                                          const Rows<N>& x, const float (&v)[TC]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int q = 0; q < TC; ++q) {
      p[q] = __fmaf_rn(x.r[i], st[I0 + i][q], p[q]);
      st[I0 + i][q] = __fadd_rn(__fmul_rn(x.w[i], st[I0 + i][q]), __fmul_rn(x.k[i], v[q]));
    }
  }
}

template <int HD, int TR>
__global__ void __launch_bounds__(Tile<HD, TR>::kThreads, Tile<HD, TR>::kMinBlocks)
wkv6_chunk_kernel(const Args a, const bool vec) {
  using T = Tile<HD, TR>;
  constexpr int NT = T::kThreads, NC = T::kCols, NW = T::kWarps, W = T::kWarpRows;
  constexpr int CH = T::kChunk, Q = HD / 4;
  // the bonus dots: P lanes a token, CPL channels a lane
  constexpr int P0 = NT / CH < 1 ? 1 : NT / CH;
  constexpr int P = P0 > 32 ? 32 : (P0 > HD / 4 ? HD / 4 : P0);
  constexpr int CPL = HD / P;
  using K = Kept<W>;
  // [buffer][r, k, v, w][token][i], then each warp's column sums
  // [warp][1 + token][j] (row 0 takes the pipeline's first, empty, store),
  // then the bonus dots [token]
  extern __shared__ __align__(16) float smem[];
  float (*buf)[4][CH][HD] = reinterpret_cast<float (*)[4][CH][HD]>(smem);
  float (*part)[CH + 1][HD] = reinterpret_cast<float (*)[CH + 1][HD]>(smem + 8 * CH * HD);
  float* cdot = smem + 8 * CH * HD + NW * (CH + 1) * HD;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = tid / NC, i0 = g * TR, j0 = (tid % NC) * TC;
  const int gl = g % W;                     // row group within the warp
  const int jk = j0 + K::offset(gl);        // the first column this lane keeps
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;

  // stage tokens [t0, t0 + n) into buffer `which`, whole rows (the
  // operands' addresses are recomputed from the kernel's parameters, which
  // hold no registers)
  auto stage = [&](int t0, int which) {
    const int n = min(CH, a.S - t0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* src = q == 0 ? a.r + b * a.rb + h * a.rh + t0 * a.rs
                         : q == 1 ? a.k + b * a.kb + h * a.kh + t0 * a.ks
                         : q == 2 ? a.v + b * a.vb + h * a.vh + t0 * a.vs
                                  : a.w + b * a.wb + h * a.wh + t0 * a.ws;
      const int64_t step = q == 0 ? a.rs : q == 1 ? a.ks : q == 2 ? a.vs : a.ws;
      if (vec) {
#pragma unroll
        for (int e0 = 0; e0 < CH * Q; e0 += NT) {
          const int e = e0 + tid, t = e / Q, c = 4 * (e % Q);
          if (((CH * Q) % NT == 0 || e < CH * Q) && t < n)
            cp_async16(&buf[which][q][t][c], src + t * step + c);
        }
      } else {
        for (int e = tid; e < n * HD; e += NT) {
          const int t = e / HD, c = e % HD;
          cp_async4(&buf[which][q][t][c], src + t * step + c);
        }
      }
    }
    cp_async_commit();
  };
  stage(0, 0);

  const int i1 = (tid % P) * CPL;  // this lane's channels of the bonus dots
  float uk[CPL];
#pragma unroll
  for (int m = 0; m < CPL; ++m) uk[m] = a.u[b * a.ub + h * a.uh + i1 + m];
  float st[TR][TC];
  load_tile<TR>(st, a, b, h, i0, j0, vec);

  // a token's column sums, reduced over the warp's row groups, into the
  // part row at shared address at
  const uint32_t pa = static_cast<uint32_t>(__cvta_generic_to_shared(&part[warp][0][jk]));
  auto put = [&](float (&p)[TC], uint32_t at) {
    reduce_warp_rows<NC, W>(p, gl);
    if (gl < TC) {  // (more row groups than columns: the others hold copies)
      if constexpr (K::kCount == 4) {
        sts4(at, p[0], p[1], p[2], p[3]);
      } else if constexpr (K::kCount == 2) {
        sts2(at, p[0], p[1]);
      } else {
        sts1(at, p[0]);
      }
    }
  };

  for (int t0 = 0, c = 0; t0 < a.S; t0 += CH, c ^= 1) {
    const int n = min(CH, a.S - t0);
    cp_async_wait_all();
    __syncthreads();  // chunk c visible; the last chunk's y pass is done with buffer c ^ 1
    if (t0 + CH < a.S) stage(t0 + CH, c ^ 1);
    const float (&ch)[4][CH][HD] = buf[c];

    // bonus dots c_t = sum_i r_i (u_i k_i), every token of the chunk at once
#pragma unroll
    for (int tb = 0; tb < CH; tb += NT / P) {
      const int t = tb + tid / P;
      float d = 0.f;
      if (t < n) {
#pragma unroll
        for (int m = 0; m < CPL; m += 4) {
          const float4 r4 = *reinterpret_cast<const float4*>(&ch[0][t][i1 + m]);
          const float4 k4 = *reinterpret_cast<const float4*>(&ch[1][t][i1 + m]);
          d = __fmaf_rn(r4.x, __fmul_rn(uk[m], k4.x), d);
          d = __fmaf_rn(r4.y, __fmul_rn(uk[m + 1], k4.y), d);
          d = __fmaf_rn(r4.z, __fmul_rn(uk[m + 2], k4.z), d);
          d = __fmaf_rn(r4.w, __fmul_rn(uk[m + 3], k4.w), d);
        }
      }
#pragma unroll
      for (int off = 1; off < P; off <<= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
      if (tid % P == 0 && t < n) cdot[t] = d;
    }

    // The tokens, software pipelined so that neither the shared loads nor
    // the shuffles hold the arithmetic up: rows are loaded half a tile
    // ahead (the second half of this token's rows while the first half is
    // updated, the next token's first half and v while the second half
    // is), and the last token's column sums are reduced after this
    // token's entries are updated.  (After the chunk's last token the
    // loads read rows of the next array, or of part: shared memory that
    // is never used.)
    const uint32_t ra = static_cast<uint32_t>(__cvta_generic_to_shared(&ch[0][0][i0]));
    const uint32_t va = static_cast<uint32_t>(__cvta_generic_to_shared(&ch[2][0][j0]));
    constexpr int HR = TR / 2;
    Rows<HR> lo, hi;
    float v[TC], vn[TC];
    lo.load<CH * HD>(ra);
    lds_row<TC>(v, va);
    float prev[TC] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const uint32_t at = ra + 4 * HD * t;
      hi.load<CH * HD>(at + 4 * HR);
      float p[TC] = {0.f, 0.f, 0.f, 0.f};
      step_rows<0, HR, TR>(st, p, lo, v);
      lo.load<CH * HD>(at + 4 * HD);
      lds_row<TC>(vn, va + 4 * HD * (t + 1));
      step_rows<HR, HR, TR>(st, p, hi, v);
      put(prev, pa + 4 * HD * t);  // token t - 1's sums, in row t
#pragma unroll
      for (int q = 0; q < TC; ++q) {
        prev[q] = p[q];
        v[q] = vn[q];
      }
    }
    put(prev, pa + 4 * HD * n);
    __syncthreads();  // the chunk's column sums and bonus dots are complete

    // y = the warps' column sums, in warp order, + c_t v; whole rows
#pragma unroll
    for (int e0 = 0; e0 < CH * Q; e0 += NT) {
      const int e = e0 + tid, t = e / Q, j = 4 * (e % Q);
      if (((CH * Q) % NT == 0 || e < CH * Q) && t < n) {
        float4 s4 = *reinterpret_cast<const float4*>(&part[0][t + 1][j]);
#pragma unroll
        for (int w = 1; w < NW; ++w) {
          const float4 x = *reinterpret_cast<const float4*>(&part[w][t + 1][j]);
          s4.x += x.x; s4.y += x.y; s4.z += x.z; s4.w += x.w;
        }
        const float4 v4 = *reinterpret_cast<const float4*>(&ch[2][t][j]);
        const float d = cdot[t];
        const float4 o = make_float4(__fmaf_rn(d, v4.x, s4.x), __fmaf_rn(d, v4.y, s4.y),
                                     __fmaf_rn(d, v4.z, s4.z), __fmaf_rn(d, v4.w, s4.w));
        float* yp = a.y + b * a.yb + h * a.yh + (t0 + t) * a.ys + j;
        if (vec) {
          *reinterpret_cast<float4*>(yp) = o;
        } else {
          yp[0] = o.x; yp[1] = o.y; yp[2] = o.z; yp[3] = o.w;
        }
      }
    }
  }
  store_tile<TR>(st, a, b, h, i0, j0, vec);
}

// The one-token kernel (S == 1): no staging; every load in flight at once.
template <int HD, int TR>
__global__ void __launch_bounds__(Tile<HD, TR>::kThreads, Tile<HD, TR>::kMinBlocks)
wkv6_token_kernel(const Args a, const bool vec) {
  using T = Tile<HD, TR>;
  constexpr int NC = T::kCols, NW = T::kWarps, W = T::kWarpRows;
  using K = Kept<W>;
  __shared__ __align__(16) float part[NW][HD];  // each warp's column sums
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = tid / NC, i0 = g * TR, j0 = (tid % NC) * TC;
  const int gl = g % W;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;

  float st[TR][TC], r[TR], w[TR], k[TR], u[TR], v[TC];
  load_tile<TR>(st, a, b, h, i0, j0, vec);
  load_row<TR>(r, a.r + b * a.rb + h * a.rh + i0, vec);
  load_row<TR>(w, a.w + b * a.wb + h * a.wh + i0, vec);
  load_row<TR>(k, a.k + b * a.kb + h * a.kh + i0, vec);
  load_row<TC>(v, a.v + b * a.vb + h * a.vh + j0, vec);
#pragma unroll
  for (int i = 0; i < TR; ++i) u[i] = a.u[b * a.ub + h * a.uh + i0 + i];

  float d = 0.f;  // this tile's rows of the bonus dot c
#pragma unroll
  for (int i = 0; i < TR; ++i) d = __fmaf_rn(r[i], __fmul_rn(u[i], k[i]), d);
  float p[TC] = {0.f, 0.f, 0.f, 0.f};
  step_tile<TR>(st, p, r, w, k, v);
  store_tile<TR>(st, a, b, h, i0, j0, vec);
#pragma unroll
  for (int q = 0; q < TC; ++q) p[q] = __fmaf_rn(d, v[q], p[q]);  // + c v_j
  reduce_warp_rows<NC, W>(p, gl);
  if (gl < TC) {
#pragma unroll
    for (int q = 0; q < K::kCount; ++q) part[warp][j0 + K::offset(gl) + q] = p[q];
  }
  __syncthreads();
  if (tid < HD) {  // over the warps, in order
    float s = part[0][tid];
#pragma unroll
    for (int q = 1; q < NW; ++q) s += part[q][tid];
    a.y[b * a.yb + h * a.yh + tid] = s;
  }
}

template <int HD, int TR>
cudaError_t launch(const Args& a, bool vec, cudaStream_t st) {
  using T = Tile<HD, TR>;
  const dim3 grid(static_cast<unsigned>(a.B) * static_cast<unsigned>(a.H));
  if (a.S == 1) {
    wkv6_token_kernel<HD, TR><<<grid, T::kThreads, 0, st>>>(a, vec);
    return cudaGetLastError();
  }
  static bool configured = false;  // set at the first prefill, before any graph capture
  if (!configured && T::kSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_chunk_kernel<HD, TR>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (e != cudaSuccess) return e;
  }
  configured = true;
  wkv6_chunk_kernel<HD, TR><<<grid, T::kThreads, T::kSmem, st>>>(a, vec);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

// Strides in elements, in the order of Args.  s0 may be null; sT may
// equal s0.  hd is 16, 32, 64 or 128; rows is the state tile's rows a
// thread: 0 for hd's default (hd 64: 8 for a prefill, 4 for a decode
// step), or one that is built (16: 2; 32: 4; 64: 4, 8; 128: 8).
int wkv6_fwd_rows(const void* r, const void* k, const void* v, const void* w,
                  const void* u, const void* s0, void* y, void* sT,
                  int B, int S, int H, int hd,
                  int64_t rb, int64_t rs, int64_t rh, int64_t kb, int64_t ks, int64_t kh,
                  int64_t vb, int64_t vs, int64_t vh, int64_t wb, int64_t ws, int64_t wh,
                  int64_t ub, int64_t uh, int64_t s0b, int64_t s0h, int64_t s0i,
                  int64_t yb, int64_t ys, int64_t yh, int64_t sTb, int64_t sTh, int64_t sTi,
                  int rows, void* stream) {
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(r), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(w),
               static_cast<const float*>(u), static_cast<const float*>(s0),
               static_cast<float*>(y), static_cast<float*>(sT), B, S, H,
               rb, rs, rh, kb, ks, kh, vb, vs, vh, wb, ws, wh,
               ub, uh, s0b, s0h, s0i, yb, ys, yh, sTb, sTh, sTi};
  bool vec = aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w) && aligned16(y) &&
             aligned16(sT) && (s0 == nullptr || aligned16(s0));
  for (const int64_t s : {rb, rs, rh, kb, ks, kh, vb, vs, vh, wb, ws, wh, yb, ys, yh,
                          sTb, sTh, sTi})
    vec = vec && s % 4 == 0;
  if (s0 != nullptr) vec = vec && s0b % 4 == 0 && s0h % 4 == 0 && s0i % 4 == 0;
  if (rows == 0) rows = hd == 16 ? 2 : hd == 32 ? 4 : hd == 128 ? 8 : S == 1 ? 4 : 8;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch (hd * 100 + rows) {
    case 1602: e = launch<16, 2>(a, vec, st); break;
    case 3204: e = launch<32, 4>(a, vec, st); break;
    case 6404: e = launch<64, 4>(a, vec, st); break;
    case 6408: e = launch<64, 8>(a, vec, st); break;
    case 12808: e = launch<128, 8>(a, vec, st); break;
    default: break;
  }
  return static_cast<int>(e);
}

// The default tiles of hd.
int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* y, void* sT,
             int B, int S, int H, int hd,
             int64_t rb, int64_t rs, int64_t rh, int64_t kb, int64_t ks, int64_t kh,
             int64_t vb, int64_t vs, int64_t vh, int64_t wb, int64_t ws, int64_t wh,
             int64_t ub, int64_t uh, int64_t s0b, int64_t s0h, int64_t s0i,
             int64_t yb, int64_t ys, int64_t yh, int64_t sTb, int64_t sTh, int64_t sTi,
             void* stream) {
  return wkv6_fwd_rows(r, k, v, w, u, s0, y, sT, B, S, H, hd, rb, rs, rh, kb, ks, kh,
                       vb, vs, vh, wb, ws, wh, ub, uh, s0b, s0h, s0i, yb, ys, yh,
                       sTb, sTh, sTi, 0, stream);
}

}  // extern "C"
