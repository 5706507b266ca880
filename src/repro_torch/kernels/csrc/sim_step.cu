// Hand-written Hopper (sm_90a) kernels of the device lane machine's hot step.
//
// sim_step_primitive_update replaces the TPU kernel
//   src/repro/kernels/sim_step.py::masked_primitive_update
//   (Pallas bodies _step_kernel and _step_gen_kernel):
// one masked primitive (work / idle / checkpoint) per lane -- fault check,
// t / saved / unsaved / period-work update, int32 outcome bitfield -- and, in
// its generating variant (gen != 0), the refill of the strike cursor on the
// lanes that faulted: one SplitMix64 draw, the inverse-CDF gap, retirement
// to +inf past the lane's horizon.
//
// sim_step_stream_advance replaces the TPU kernel
//   src/repro/kernels/sim_step.py::masked_stream_advance (_advance_kernel):
// advance a renewal-stream cursor (ctr, tm) by one event where the mask is
// set.
//
// Both come in two variants, templated on Indexed: the single-law one takes
// one (law, p1, p2) per launch; the law-indexed one (entry points
// *_indexed) replaces the reference's kind="indexed" bodies of both Pallas
// kernels (the mixed-law sweep) and reads each lane's law code and shape
// slots from three more per-lane arrays.  Lanes are cell-ordered, so a
// warp mixes laws only at a cell boundary and the per-lane switch diverges
// little.
//
// Layout: one thread per lane, grid-stride, over flat contiguous (L,)
// arrays (the TPU kernels' (rows, 128) slab layout is not carried over).
// Times are f64, prim / cont / flags / ctr int32, the stream key an int64
// bit pattern read as uint64_t, the mask one byte (torch.bool).  State is
// updated in place, as the Pallas input_output_aliases do: t / saved /
// unsaved / pw and the strike cursor (ctr, nf) in kernel 1, (ctr, tm) in
// kernel 2.  Kernels allocate nothing and launch on the caller's stream;
// each C entry point returns cudaGetLastError().
//
// What bounds them on an H100: both are elementwise with a handful of f64
// operations per lane (the transcendental gap only on the lanes that
// draw), so device memory, not arithmetic, is the roofline.  Kernel 1
// moves 156 B per lane in its generating variant (reads 108: prim, cont,
// ctr 4 B each; target, ckend, nf, t, saved, unsaved, pw, W, DR, key, mean,
// horizon 8 B each; writes 48: t, saved, unsaved, pw, tm 8 B each, flags,
// ctr 4 B each) and kernel 2 moves 49 B per lane (reads mask 1, ctr 4, tm,
// key, mean, horizon 8 each; writes ctr 4, tm 8); the law-indexed variant
// reads 20 B more (law 4, s1 8, s2 8) on each lane that draws.  At the
// lane counts of the paper grid (about 10^5 lanes, 5-17 MB a launch;
// twice that for the mixed-law grid) a launch's bytes take
// a few microseconds at 3.35 TB/s, the same order as the launch itself, so
// the design keeps each step to one launch and one pass over the lanes:
// coalesced loads (neighbouring threads on neighbouring lanes), every
// intermediate in registers, no shared memory, no synchronisation.
//
// Numerics: build with --fmad=false.  Otherwise nvcc contracts
// tm + g and the lognormal exponent into FMAs, and the kernels differ in
// the last bits from their plain PyTorch versions (and from the
// reference).  The Weibull exponent mirrors the reference's pow strength
// reductions (exponent 2 -> x * x, 0.5 -> sqrt).

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr uint64_t kSmGamma = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kSmMix1 = 0xBF58476D1CE4E5B9ull;
constexpr uint64_t kSmMix2 = 0x94D049BB133111EBull;
constexpr double kTwoPi = 6.283185307179586;  // 2.0 * 3.141592653589793

// law codes: repro_torch.core.events.LAW_*
constexpr int kLawExponential = 0;
constexpr int kLawWeibull = 1;
constexpr int kLawLognormal = 2;
constexpr int kLawUniform = 3;

// outcome bitfield: repro_torch.kernels.sim_step.FLAG_*
constexpr int kFlagFaulted = 1;
constexpr int kFlagOk = 2;
constexpr int kFlagFin = 4;
constexpr int kFlagCkptOk = 8;
constexpr int kFlagReg = 16;

// primitive kinds: repro_torch.kernels.sim_step.PRIM_*
constexpr int kPrimWork = 1;
constexpr int kPrimIdle = 2;
constexpr int kPrimCkpt = 3;
constexpr int kPrimWorkNc = 4;

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;

__device__ __forceinline__ void splitmix64(uint64_t key, int32_t ctr,
                                           uint32_t* hi, uint32_t* lo) {
  uint64_t z = key + (static_cast<uint64_t>(ctr) + 1ull) * kSmGamma;
  z = (z ^ (z >> 30)) * kSmMix1;
  z = (z ^ (z >> 27)) * kSmMix2;
  z = z ^ (z >> 31);
  *hi = static_cast<uint32_t>(z >> 32);
  *lo = static_cast<uint32_t>(z);
}

__device__ __forceinline__ double uniform24(uint32_t bits) {
  return (static_cast<double>(bits >> 8) + 0.5) * 0x1p-24;
}

// Inverse-CDF gap of one counter draw.  p1 / p2 are the host-folded shape
// constants: Weibull p1 = 1 / Gamma(1 + 1/k), p2 = 1/k; lognormal
// p1 = sigma, p2 = sigma^2 / 2.
__device__ __forceinline__ double gap_transform(int law, double p1, double p2,
                                                double mean, uint32_t x0,
                                                uint32_t x1) {
  const double u = uniform24(x0);
  double g;
  switch (law) {
    case kLawWeibull: {
      const double nlog = -log1p(-u);
      double p;
      if (p2 == 2.0) {
        p = nlog * nlog;
      } else if (p2 == 0.5) {
        p = sqrt(nlog);
      } else {
        p = pow(nlog, p2);
      }
      g = (mean * p1) * p;
      break;
    }
    case kLawLognormal: {
      const double z = sqrt(-2.0 * log(u)) * cos(kTwoPi * uniform24(x1));
      g = exp((log(mean) - p2) + p1 * z);
      break;
    }
    case kLawUniform:
      g = (2.0 * mean) * u;
      break;
    default:  // kLawExponential
      g = -log1p(-u) * mean;
      break;
  }
  // NaN-propagating max, as jnp.maximum / torch.clamp
  return g < 1e-9 ? 1e-9 : g;
}

// Draw ctr + 1 and add its gap to tm; retire past the horizon.
__device__ __forceinline__ void advance(uint64_t key, int32_t* ctr, double* tm,
                                        double mean, double horizon, int law,
                                        double p1, double p2) {
  const int32_t c2 = *ctr + 1;
  uint32_t x0, x1;
  splitmix64(key, c2, &x0, &x1);
  double t2 = *tm + gap_transform(law, p1, p2, mean, x0, x1);
  if (t2 > horizon) t2 = INFINITY;
  *ctr = c2;
  *tm = t2;
}

// Indexed = true is the law-indexed variant (the reference's kind="indexed"
// bodies): each lane reads its own law code and shape slots (law_i, s1,
// s2) and passes them to the same gap_transform, whose switch computes the
// lane's branch only.  So a lane of law X gets the single-law launch's bits
// for X by construction.  Indexed = false compiles the per-launch (law, p1,
// p2) variant without those loads.
template <bool Indexed>
__global__ void primitive_update_kernel(
    int64_t n, const int32_t* __restrict__ prim,
    const int32_t* __restrict__ cont, const double* __restrict__ target,
    const double* __restrict__ ckend, double* __restrict__ nf,
    double* __restrict__ t, double* __restrict__ saved,
    double* __restrict__ unsaved, double* __restrict__ pw,
    const double* __restrict__ W, const double* __restrict__ DR,
    int32_t* __restrict__ flags, double eps, int32_t reg_cont, int32_t gen,
    const int64_t* __restrict__ key, int32_t* __restrict__ ctr,
    const double* __restrict__ mean, const double* __restrict__ horizon,
    int32_t law, double p1, double p2, const int32_t* __restrict__ law_i,
    const double* __restrict__ s1, const double* __restrict__ s2) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int32_t pr = prim[i];
    const bool creditb = pr == kPrimWork;
    const bool workm = creditb || pr == kPrimWorkNc;
    const bool idlem = pr == kPrimIdle;
    const bool ckm = pr == kPrimCkpt;
    const bool res = workm || idlem || ckm;

    const double f = nf[i];
    const double tg = target[i];
    const double ce = ckend[i];
    const double t0 = t[i];
    const double sv = saved[i];

    const bool faulted = ((workm || idlem) && f <= tg) || (ckm && f < ce);
    const bool ok = res && !faulted;

    const double t1 = faulted ? f + DR[i] : t0;
    const double unsaved1 = faulted ? 0.0 : unsaved[i];
    const double pw1 = faulted ? 0.0 : pw[i];

    const bool wok = workm && ok;
    const double dt = tg - t0;
    const double unsaved2 = wok ? unsaved1 + dt : unsaved1;
    const double pw2 = (wok && creditb) ? pw1 + dt : pw1;
    const double t2 = wok ? tg : t1;
    const bool fin = wok && (sv + unsaved2 >= W[i] - eps);

    const bool iok = idlem && ok;
    const double t3 = iok ? tg : t2;

    const bool cok = ckm && ok;
    const double t4 = cok ? ce : t3;
    const double saved2 = cok ? sv + unsaved2 : sv;
    const double unsaved3 = cok ? 0.0 : unsaved2;
    const bool reg = cok && cont[i] == reg_cont;
    const double pw3 = reg ? 0.0 : pw2;

    t[i] = t4;
    saved[i] = saved2;
    unsaved[i] = unsaved3;
    pw[i] = pw3;
    flags[i] = (faulted ? kFlagFaulted : 0) + (ok ? kFlagOk : 0) +
               (fin ? kFlagFin : 0) + (cok ? kFlagCkptOk : 0) +
               (reg ? kFlagReg : 0);

    if (gen && faulted) {
      // the struck fault is consumed: refill the strike cursor (nf is its
      // date) with the stream's next event
      int32_t c = ctr[i];
      double tm = f;
      if constexpr (Indexed) {
        advance(static_cast<uint64_t>(key[i]), &c, &tm, mean[i], horizon[i],
                law_i[i], s1[i], s2[i]);
      } else {
        advance(static_cast<uint64_t>(key[i]), &c, &tm, mean[i], horizon[i],
                law, p1, p2);
      }
      ctr[i] = c;
      nf[i] = tm;
    }
  }
}

template <bool Indexed>
__global__ void stream_advance_kernel(
    int64_t n, const bool* __restrict__ mask, int32_t* __restrict__ ctr,
    double* __restrict__ tm, const int64_t* __restrict__ key,
    const double* __restrict__ mean, const double* __restrict__ horizon,
    int32_t law, double p1, double p2, const int32_t* __restrict__ law_i,
    const double* __restrict__ s1, const double* __restrict__ s2) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    if (!mask[i]) continue;
    int32_t c = ctr[i];
    double m = tm[i];
    if constexpr (Indexed) {
      advance(static_cast<uint64_t>(key[i]), &c, &m, mean[i], horizon[i],
              law_i[i], s1[i], s2[i]);
    } else {
      advance(static_cast<uint64_t>(key[i]), &c, &m, mean[i], horizon[i], law,
              p1, p2);
    }
    ctr[i] = c;
    tm[i] = m;
  }
}

unsigned int blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" int sim_step_primitive_update(
    int64_t n, const int32_t* prim, const int32_t* cont, const double* target,
    const double* ckend, double* nf, double* t, double* saved, double* unsaved,
    double* pw, const double* W, const double* DR, int32_t* flags, double eps,
    int32_t reg_cont, int32_t gen, const int64_t* key, int32_t* ctr,
    const double* mean, const double* horizon, int32_t law, double p1,
    double p2, void* stream) {
  if (n <= 0) return 0;
  primitive_update_kernel<false><<<blocks_for(n), kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      n, prim, cont, target, ckend, nf, t, saved, unsaved, pw, W, DR, flags,
      eps, reg_cont, gen, key, ctr, mean, horizon, law, p1, p2, nullptr,
      nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// The law-indexed variant (always refills the strike cursor): law_i is the
// per-lane int32 law code, s1 / s2 the per-lane f64 shape slots.
extern "C" int sim_step_primitive_update_indexed(
    int64_t n, const int32_t* prim, const int32_t* cont, const double* target,
    const double* ckend, double* nf, double* t, double* saved, double* unsaved,
    double* pw, const double* W, const double* DR, int32_t* flags, double eps,
    int32_t reg_cont, const int64_t* key, int32_t* ctr, const double* mean,
    const double* horizon, const int32_t* law_i, const double* s1,
    const double* s2, void* stream) {
  if (n <= 0) return 0;
  primitive_update_kernel<true><<<blocks_for(n), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      n, prim, cont, target, ckend, nf, t, saved, unsaved, pw, W, DR, flags,
      eps, reg_cont, 1, key, ctr, mean, horizon, kLawExponential, 0.0, 0.0,
      law_i, s1, s2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sim_step_stream_advance(int64_t n, const bool* mask,
                                       int32_t* ctr, double* tm,
                                       const int64_t* key, const double* mean,
                                       const double* horizon, int32_t law,
                                       double p1, double p2, void* stream) {
  if (n <= 0) return 0;
  stream_advance_kernel<false><<<blocks_for(n), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      n, mask, ctr, tm, key, mean, horizon, law, p1, p2, nullptr, nullptr,
      nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sim_step_stream_advance_indexed(
    int64_t n, const bool* mask, int32_t* ctr, double* tm, const int64_t* key,
    const double* mean, const double* horizon, const int32_t* law_i,
    const double* s1, const double* s2, void* stream) {
  if (n <= 0) return 0;
  stream_advance_kernel<true><<<blocks_for(n), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      n, mask, ctr, tm, key, mean, horizon, kLawExponential, 0.0, 0.0, law_i,
      s1, s2);
  return static_cast<int>(cudaGetLastError());
}
