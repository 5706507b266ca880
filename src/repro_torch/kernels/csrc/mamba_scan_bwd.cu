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
//      chunk's start state, recomputes the chunk's states and decays into
//      registers, then runs G backwards over them, writing ddt and dx, dh0,
//      per-batch-row partials of dA, and for every token a partial of dB
//      and dC over the channel groups the block walks.
//   3. scan_bwd_reduce_kernel adds the partials in a fixed order: dB and dC
//      over the blocks of a batch row, dA over the batch.  No atomics
//      anywhere, so two runs give the same bits.
//
// Numerics.  Built with --fmad=false, every product and sum rounded alone
// (__fmul_rn / __fadd_rn) and expf libdevice's, as the plain version rounds
// them (and as csrc/mamba_scan.cu does): the recomputed states are the
// forward's bits, and the elementwise G (hence dh0) is the plain version's
// bit for bit.  The reductions (over s for du and ddt, over d for dB / dC,
// over b and t for dA) take other orders than the plain version's and are
// held to it within a tolerance.
//
// Layout.  dt, x, dy, ddt, dx (batch, seq, d); B, C, dB, dC (batch, seq,
// ds); A, dA (d, ds); h0, dhT, dh0 (batch, d, ds); all contiguous f32, and
// A, h0, dhT, dh0 16-byte aligned.  h0 and dhT may be null (zeros), dh0
// null (not wanted).
//
// What bounds it on an H100 (Jamba-1.5-Large training: B 8, S 1024, d
// 16384, ds 16): reading dt, x, dy and writing ddt, dx moves 5 x 537 MB,
// 0.80 ms at 3.35 TB/s; the 2.15e9 state entries take ~20 f32 operations a
// token each, 0.64 ms at 67 TFLOP/s.  What the card issues is more: the
// state's exp, libdevice's expf, is ~8 instructions (one of them on the
// eighth-rate MUFU pipe) and runs twice an entry and token (the states
// pass, the recompute), a product and a sum issue as two instructions
// without contraction, and the sums over s and over d take shuffle trees:
// ~48 instructions an entry and token in the two passes, ~3.1 ms at one
// instruction a cycle on each of the 528 schedulers.
//
// Design.  A channel's ds states are split over ds / 4 lanes, 4 states a
// lane, so a thread keeps its chunk's kChunk + 1 states and kChunk decays
// in registers (the first design gave a thread all 16 states of a channel,
// used 255 registers and ran 8 warps an SM with a third exp an entry, for
// the reverse step).  A block of 128 channels is 512 threads at ds 16, 16
// warps an SM.  Tokens go in pairs: du and ddt's sums over s fold over the
// channel's lanes, and dB and dC's sums over the warp's channels fold 16
// values (two tokens' 8) over the channel lanes in one transpose-reduce
// tree (14 shuffles a pair, where the first design spent 32 a token); the
// warps' sums meet in shared memory and are added in order while the next
// chunk computes.  A block walks every P-th group of 128 channels of its
// batch row (P = selective_scan_bwd_parts(B, D), ~132 blocks in all) and
// adds each group's dB / dC into its own partial, so the partials are B P
// S 2 ds floats, not B (D / 128) S 2 ds.  A chunk's dt, x, dy, B and C rows,
// the thread's start state and the partial the flush adds to are staged
// with cp.async into a double buffer while the previous chunk computes; a
// warp's channels write ddt and dx as whole sectors.  Every full chunk is
// unrolled without a bound check on each token.  The states pass takes the
// same lane split and staging (the first design's, a thread a channel, ran
// 8 exps a token on 12 warps an SM and waited on its own loads twice a
// chunk).  The chunk-start scratch keeps its stride of 8 tokens (1.07 GB at
// the training shape): a 16-token chunk would need 136 registers of states
// and decays a thread.
//
// Times at the training shape (PERF.md §6, tools/bwd_ab.py, NVIDIA H100
// 80GB HBM3 at 700 W): 5.32 ms (states 1.29, reverse 3.97, reduce 0.013),
// against the first design's 7.86-7.90 ms (2.17, 5.61-5.98, 0.054).  Timed
// variants on the card put the reverse at ~58% of the SMs' issue rate, each
// instruction an entry costing ~0.11 ms: removing the dB / dC fold took
// 0.79 ms off it, the recompute's expf 0.63, the du / ddt fold 0.41, dA's
// sum 0.23; 8 warps an SM instead of 16 added 1.6 ms, and the decays kept
// in shared memory instead of registers, or dB / dC summed through shared
// memory instead of shuffles, were slower.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChannels = 128;  // channels of one batch row a group
constexpr int kChunk = 8;       // tokens a chunk
constexpr int kTargetBlocks = 132;  // blocks the reverse kernel aims at (one H100 wave)
constexpr unsigned kFull = 0xffffffffu;

// a compile-time flag for the generic lambdas that unroll a whole chunk
// without a bound check on each token
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

template <int DS>
struct Tile {
  static constexpr int kLanes = DS / 4;                // lanes a channel, 4 states each
  static constexpr int kThreads = kChannels * kLanes;  // 512 at ds 16, 256 at ds 8
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kTok = 3 * kChannels + 2 * DS;  // a staged token: dt, x, dy, B, C
  static constexpr int kStageFloats = 2 * kChunk * kTok;
  // staging, two chunks' warp dB / dC, start states and dB / dC partials
  static constexpr int kSmem =
      (kStageFloats + 2 * kChunk * (kWarps + 1) * 2 * DS + 2 * kThreads * 4) * 4;
  static constexpr int kStatesTok = 2 * kChannels + DS;  // the states pass: dt, x, B
  static constexpr int kStatesSmem = 2 * kChunk * kStatesTok * 4;
};

struct Args {
  const float *dt, *x, *A, *Bc, *Cc, *h0, *dy, *dhT;
  float *ddt, *dx, *dA, *dB, *dC, *dh0;
  float *states, *bc_part, *dA_part;
  int B, S, D, parts;
  int vec;  // dt, x, dy, B, C 16-byte aligned and d a multiple of 4: stage 16 bytes a copy
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

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// Stage tokens t0 .. t0 + n - 1 into buf ([kChunk][NA kChannels + NR ds]):
// the first NA of dt, x, dy for channels d0 .. d0 + live - 1 of the batch
// row starting at seq, then the first NR of its B and C rows, with cp.async
// copies of 16 bytes (a.vec) or 4 (any d's alignment); the caller commits.
template <int DS, int NA, int NR, int NT>
__device__ __forceinline__ void stage(const Args& a, float* buf, int64_t seq, int d0, int live,
                                      int t0, int n) {
  constexpr int P = NA * kChannels, TOK = P + NR * DS, Q = TOK / 4;
  if (a.vec) {
    for (int q = threadIdx.x; q < n * Q; q += NT) {
      const int tt = q / Q, f = 4 * (q % Q);
      const int64_t t = seq + t0 + tt;
      if (f < P) {
        const int which = f / kChannels, ch = f % kChannels;
        if (ch < live) {
          const float* src = which == 0 ? a.dt : which == 1 ? a.x : a.dy;
          cp_async16(buf + tt * TOK + f, src + t * a.D + d0 + ch);
        }
      } else {
        const int s = f - P;
        cp_async16(buf + tt * TOK + f, (s < DS ? a.Bc + t * DS + s : a.Cc + t * DS + s - DS));
      }
    }
    return;
  }
  for (int q = threadIdx.x; q < n * TOK; q += NT) {
    const int tt = q / TOK, f = q % TOK;
    const int64_t t = seq + t0 + tt;
    if (f < P) {
      const int which = f / kChannels, ch = f % kChannels;
      if (ch < live) {
        const float* src = which == 0 ? a.dt : which == 1 ? a.x : a.dy;
        cp_async4(buf + tt * TOK + f, src + t * a.D + d0 + ch);
      }
    } else {
      const int s = f - P;
      cp_async4(buf + tt * TOK + f, (s < DS ? a.Bc + t * DS + s : a.Cc + t * DS + s - DS));
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void load4(float (&v)[4], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}

template <int DS>
__global__ void __launch_bounds__(Tile<DS>::kThreads, 2) scan_bwd_states_kernel(const Args a) {
  using T = Tile<DS>;
  constexpr int L = T::kLanes, TOK = T::kStatesTok;
  extern __shared__ float4 smem4[];
  float* sbuf = reinterpret_cast<float*>(smem4);  // [2][kChunk][dt, x, B]
  const int tid = threadIdx.x, ch = tid / L, sg = tid % L;
  const int b = blockIdx.y, d0 = blockIdx.x * kChannels, d = d0 + ch;
  const int nlive = min(kChannels, a.D - d0);
  const bool live = ch < nlive;
  const int64_t seq = static_cast<int64_t>(b) * a.S;
  const int64_t row = (static_cast<int64_t>(b) * a.D + d) * DS + 4 * sg;
  float h[4] = {0.f, 0.f, 0.f, 0.f}, A[4] = {0.f, 0.f, 0.f, 0.f};
  if (live) {
    load4(A, a.A + static_cast<int64_t>(d) * DS + 4 * sg);
    if (a.h0 != nullptr) load4(h, a.h0 + row);
  }
  const int nc = (a.S + kChunk - 1) / kChunk;
  if (nlive < kChannels) {  // dead channels read zeros: their states stay 0
    for (int q = threadIdx.x; q < 2 * kChunk * 2 * kChannels; q += T::kThreads) {
      const int cc = q % kChannels, row = q / kChannels;
      if (cc >= nlive) sbuf[(row / 2) * TOK + (row % 2) * kChannels + cc] = 0.f;
    }
  }
  stage<DS, 2, 1, T::kThreads>(a, sbuf, seq, d0, nlive, 0, min(kChunk, a.S));
  cp_async_commit();
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * kChunk, n = min(kChunk, a.S - t0);
    const float* cur = sbuf + (c & 1) * kChunk * TOK;
    if (live)
      *reinterpret_cast<float4*>(
          a.states + ((static_cast<int64_t>(b) * nc + c) * a.D + d) * DS + 4 * sg) =
          make_float4(h[0], h[1], h[2], h[3]);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // chunk c is staged; every thread is done with chunk c - 1's buffer
    if (c + 1 < nc) {
      stage<DS, 2, 1, T::kThreads>(a, sbuf + ((c + 1) & 1) * kChunk * TOK, seq, d0, nlive,
                                   t0 + kChunk, min(kChunk, a.S - t0 - kChunk));
      cp_async_commit();
    }
    // a whole chunk unrolled without a bound check on each token
    auto run_chunk = [&](auto full) {
#pragma unroll
      for (int tt = 0; tt < kChunk; ++tt) {
        if (decltype(full)::value || tt < n) {
          const float* tk = cur + tt * TOK;
          const float dtt = tk[ch], u = __fmul_rn(dtt, tk[kChannels + ch]);
          float Bs[4];
          load4(Bs, tk + 2 * kChannels + 4 * sg);
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const float da = expf(__fmul_rn(dtt, A[s]));
            h[s] = __fadd_rn(__fmul_rn(da, h[s]), __fmul_rn(u, Bs[s]));
          }
        }
      }
    };
    if (n == kChunk) run_chunk(Flag<true>());
    else run_chunk(Flag<false>());
  }
}

template <int DS>
__global__ void __launch_bounds__(Tile<DS>::kThreads, 1) scan_bwd_reverse_kernel(const Args a) {
  using T = Tile<DS>;
  constexpr int L = T::kLanes, NW = T::kWarps, NV = 2 * DS, NT = T::kThreads;
  extern __shared__ float4 smem4[];
  float* sbuf = reinterpret_cast<float*>(smem4);  // [2][kChunk][kTok]
  float* sred = sbuf + T::kStageFloats;            // [2][kChunk][NW][dB s, then dC s]
  float* sstart = sred + 2 * kChunk * NW * NV;     // [2][NT][4]: each thread's chunk start
  float* spart = sstart + 2 * NT * 4;              // [2][kChunk][NV]: the partials so far
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ch = tid / L, sg = tid % L;
  // after the dB / dC fold of a token pair a lane holds values q_bc .. of its
  // state group: value q is token q >> 3's dB (bit 2 of q clear) or dC of
  // state 4 sg + (q & 3)
  const int q_bc = fold_index<16, 16, L>(lane);
  const int b = blockIdx.y;
  const int64_t seq = static_cast<int64_t>(b) * a.S;
  const int ngroups = (a.D + kChannels - 1) / kChannels;
  const int nc = (a.S + kChunk - 1) / kChunk;
  float* part = a.bc_part + (static_cast<int64_t>(b) * a.parts + blockIdx.x) * a.S * NV;
  for (int grp = blockIdx.x; grp < ngroups; grp += a.parts) {
    const int d0 = grp * kChannels, d = d0 + ch, nlive = min(kChannels, a.D - d0);
    const bool live = ch < nlive;
    const bool first = grp == static_cast<int>(blockIdx.x);  // this block's first group
    const int64_t row = (static_cast<int64_t>(b) * a.D + d) * DS + 4 * sg;
    float A[4], Gc[4], dA[4];
    if (live) {
      const float4 av = *reinterpret_cast<const float4*>(a.A + static_cast<int64_t>(d) * DS + 4 * sg);
      A[0] = av.x, A[1] = av.y, A[2] = av.z, A[3] = av.w;
    } else {
      A[0] = A[1] = A[2] = A[3] = 0.f;
    }
    if (live && a.dhT != nullptr) {
      const float4 gv = *reinterpret_cast<const float4*>(a.dhT + row);
      Gc[0] = gv.x, Gc[1] = gv.y, Gc[2] = gv.z, Gc[3] = gv.w;
    } else {
      Gc[0] = Gc[1] = Gc[2] = Gc[3] = 0.f;
    }
    dA[0] = dA[1] = dA[2] = dA[3] = 0.f;
    // stage chunk cc into buffer bi: its rows, the thread's start state and,
    // after the block's first group, chunk cc + 1's partial so far, which
    // the flush adds to while chunk cc computes
    auto issue = [&](int cc, int bi) {
      stage<DS, 3, 2, NT>(a, sbuf + bi * kChunk * T::kTok, seq, d0, nlive, cc * kChunk,
                          min(kChunk, a.S - cc * kChunk));
      if (live)
        cp_async16(sstart + (bi * NT + tid) * 4,
                   a.states + ((static_cast<int64_t>(b) * nc + cc) * a.D + d) * DS + 4 * sg);
      if (!first && cc + 1 < nc) {
        const int t1 = (cc + 1) * kChunk, tn = min(kChunk, a.S - t1);
        for (int q = tid; q < tn * NV / 4; q += NT)
          cp_async16(spart + bi * kChunk * NV + 4 * q, part + static_cast<int64_t>(t1) * NV + 4 * q);
      }
      cp_async_commit();
    };
    // add chunk cc's warps' dB / dC from sred buffer pb in order into the
    // block's partial: after the block's first group, onto the groups
    // before, staged in spart buffer pp (or read here, pp < 0)
    auto flush = [&](int cc, int pb, int pp) {
      const int tc0 = cc * kChunk, tn = min(kChunk, a.S - tc0);
      const float* sr = sred + pb * kChunk * NW * NV;
      for (int q = tid; q < tn * NV; q += NT) {
        const int tt = q / NV, v = q % NV;
        float* o = part + static_cast<int64_t>(tc0 + tt) * NV + v;
        float sum = first ? 0.f : pp < 0 ? *o : spart[pp * kChunk * NV + q];
#pragma unroll
        for (int wp = 0; wp < NW; ++wp) sum = __fadd_rn(sum, sr[(tt * NW + wp) * NV + v]);
        *o = sum;
      }
    };
    __syncthreads();  // the previous group's reads of the staging buffers are done
    if (nlive < kChannels) {  // dead channels read zeros: no state moves, no sum grows
      for (int q = tid; q < 2 * kChunk * 3 * kChannels; q += NT) {
        const int cc = q % kChannels, row = q / kChannels;
        if (cc >= nlive) sbuf[(row / 3) * T::kTok + (row % 3) * kChannels + cc] = 0.f;
      }
      __syncthreads();
    }
    issue(nc - 1, 0);
    for (int c = nc - 1; c >= 0; --c) {
      const int t0 = c * kChunk, n = min(kChunk, a.S - t0), bi = (nc - 1 - c) & 1;
      const float* cur = sbuf + bi * kChunk * T::kTok;
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();  // chunk c is staged, chunk c + 1's dB / dC are in buffer bi ^ 1
      if (c > 0) issue(c - 1, bi ^ 1);
      // chunk c + 1's dB / dC partial is added while this chunk computes: no
      // barrier between a chunk's sums and their flush
      if (c + 1 < nc) flush(c + 1, bi ^ 1, bi);
      // a whole chunk unrolled without a bound check on each token, so that
      // the compiler overlaps one token's exps and shuffle trees with the
      // next token's; the last chunk checks
      auto run_chunk = [&](auto full) {
        constexpr bool F = decltype(full)::value;
        // hs[tt]: the state before token t0 + tt; da[tt]: token t0 + tt's decays
        float hs[kChunk + 1][4], da[kChunk][4];
        if (live) {
          load4(hs[0], sstart + (bi * NT + tid) * 4);
        } else {
          hs[0][0] = hs[0][1] = hs[0][2] = hs[0][3] = 0.f;
        }
#pragma unroll
        for (int tt = 0; tt < kChunk; ++tt) {
          if (F || tt < n) {
            const float* tk = cur + tt * T::kTok;
            const float dtt = tk[ch], u = __fmul_rn(dtt, tk[kChannels + ch]);
            float Bs[4];
            load4(Bs, tk + 3 * kChannels + 4 * sg);
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              da[tt][s] = expf(__fmul_rn(dtt, A[s]));
              hs[tt + 1][s] = __fadd_rn(__fmul_rn(da[tt][s], hs[tt][s]), __fmul_rn(u, Bs[s]));
            }
          }
        }
        // tokens in pairs, the later first: one fold tree for both tokens' sums
#pragma unroll
        for (int p = kChunk / 2 - 1; p >= 0; --p) {
          float red[4], bc[16];  // [du, ddt's sum] and [dB s, dC s] of tokens 2p, 2p + 1
#pragma unroll
          for (int k = 1; k >= 0; --k) {
            const int tt = 2 * p + k;
            if (F || tt < n) {
              const float* tk = cur + tt * T::kTok;
              const float dtt = tk[ch], dv = tk[2 * kChannels + ch];
              const float u = __fmul_rn(dtt, tk[kChannels + ch]);
              float Bs[4], Cs[4];
              load4(Bs, tk + 3 * kChannels + 4 * sg);
              load4(Cs, tk + 3 * kChannels + DS + 4 * sg);
              float du = 0.f, dz = 0.f;
#pragma unroll
              for (int s = 0; s < 4; ++s) {
                const float G = __fadd_rn(__fmul_rn(Cs[s], dv), Gc[s]);
                du = __fadd_rn(du, __fmul_rn(G, Bs[s]));
                Gc[s] = __fmul_rn(da[tt][s], G);
                const float gz = __fmul_rn(Gc[s], hs[tt][s]);
                dz = __fadd_rn(dz, __fmul_rn(gz, A[s]));
                dA[s] = __fadd_rn(dA[s], __fmul_rn(gz, dtt));
                bc[8 * k + s] = __fmul_rn(G, u);
                bc[8 * k + 4 + s] = __fmul_rn(dv, hs[tt + 1][s]);
              }
              red[2 * k] = du, red[2 * k + 1] = dz;
            } else {
              red[2 * k] = red[2 * k + 1] = 0.f;
#pragma unroll
              for (int s = 0; s < 8; ++s) bc[8 * k + s] = 0.f;
            }
          }
          // du and ddt's sum over the channel's lanes
          fold<4, L / 2, 1>(red, lane);
          const int rq = fold_index<4, L / 2, 1>(lane);  // L 4: one value; L 2: a token's pair
          float du, dz;
          if constexpr (L == 4) {
            du = red[0], dz = __shfl_xor_sync(kFull, red[0], 1);
          } else {
            du = red[0], dz = red[1];
          }
          const int tr = 2 * p + (rq >> 1);
          if ((rq & 1) == 0 && live && (F || tr < n)) {  // a warp's 8 channels: one sector
            const float* tk = cur + tr * T::kTok;
            const int64_t off = (seq + t0 + tr) * a.D + d;
            a.ddt[off] = __fadd_rn(__fmul_rn(du, tk[kChannels + ch]), dz);
            a.dx[off] = __fmul_rn(du, tk[ch]);
          }
          // dB and dC over the warp's channels
          fold<16, 16, L>(bc, lane);
          constexpr int NB = fold_left<16, 16, L>();
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            const int q = q_bc + j, tb = 2 * p + (q >> 3);
            if (F || tb < n)
              sred[((bi * kChunk + tb) * NW + warp) * NV + ((q >> 2) & 1) * DS + 4 * sg + (q & 3)] =
                  bc[j];
          }
        }
      };
      if (n == kChunk) run_chunk(Flag<true>());
      else run_chunk(Flag<false>());
    }
    __syncthreads();  // the first chunk's dB / dC are in buffer (nc - 1) & 1
    flush(0, (nc - 1) & 1, -1);
    if (live) {
      if (a.dh0 != nullptr)
        *reinterpret_cast<float4*>(a.dh0 + row) = make_float4(Gc[0], Gc[1], Gc[2], Gc[3]);
      *reinterpret_cast<float4*>(a.dA_part + row) = make_float4(dA[0], dA[1], dA[2], dA[3]);
    }
  }
}

// dB, dC: the blocks' partials of a batch row added in order; dA: the batch
// rows'
template <int DS>
__global__ void scan_bwd_reduce_kernel(const Args a) {
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
      for (int k = 0; k < a.parts; ++k)
        s = __fadd_rn(s, a.bc_part[((b * a.parts + k) * a.S + t) * NV + v]);
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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// blocks a batch row of the reverse kernel: every one walks every P-th
// group of kChannels channels
int parts(int B, int D) {
  const int groups = (D + kChannels - 1) / kChannels;
  const int p = kTargetBlocks / B;
  return p < 1 ? 1 : p < groups ? p : groups;
}

template <int DS>
cudaError_t run(const Args& a, cudaStream_t st) {
  using T = Tile<DS>;
  static bool sized = false;  // once an instantiation: the call may be in a graph capture
  cudaError_t err;
  if (!sized) {
    err = cudaFuncSetAttribute(scan_bwd_reverse_kernel<DS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const int groups = (a.D + kChannels - 1) / kChannels;
  scan_bwd_states_kernel<DS><<<dim3(groups, a.B), T::kThreads, T::kStatesSmem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_bwd_reverse_kernel<DS><<<dim3(a.parts, a.B), T::kThreads, T::kSmem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = static_cast<int64_t>(a.B) * a.S * 2 * DS + static_cast<int64_t>(a.D) * DS;
  const int blocks = static_cast<int>(n / 256 + 1 < 132 * 16 ? n / 256 + 1 : 132 * 16);
  scan_bwd_reduce_kernel<DS><<<blocks, 256, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tokens a chunk of the backward.  The caller sizes the scratch with it and
// selective_scan_bwd_parts: states B ceil(S / chunk) D ds floats, dB / dC
// partials B parts S 2 ds floats, dA partials B D ds floats.
int selective_scan_bwd_chunk(void) { return kChunk; }

// Partials of dB / dC a batch row (the reverse kernel's blocks a row).
int selective_scan_bwd_parts(int B, int D) { return B < 1 || D < 1 ? 0 : parts(B, D); }

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
               static_cast<float*>(dA_part), B, S, D, parts(B, D),
               D % 4 == 0 && aligned16(dt) && aligned16(x) && aligned16(dy) && aligned16(Bc) &&
                   aligned16(Cc)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ds) {
    case 8: return static_cast<int>(run<8>(a, st));
    case 16: return static_cast<int>(run<16>(a, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
