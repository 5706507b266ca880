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
// set.  The lane machine launches it once per chunk, to prime the strike
// cursor; every other cursor step runs in the two walks below.
//
// sim_step_prediction_walk, sim_step_strike_walk and sim_step_silent_walk
// are the same cursor step redesigned as a per-lane walk: one launch advances each lane's cursor
// as many events as the lane's own stop condition needs, where the TPU
// kernel advances every lane by one event per launch and the reference
// wraps it in a lax.while_loop (src/repro/core/jax_sim.py tp_consume,
// fp_consume and p_cond / p_body, l.319-374 and l.433-457; s_cond / s_body,
// l.664-688; sc_cond / sc_body, l.797-810).
// On the card each pass of such a loop was a launch and a host sync, and the
// loop ran until the slowest of ~10^5 lanes stopped; here a lane stops on
// its own and a warp costs the longest walk of its 32 lanes.
//   - prediction walk: the refill of the prediction cursors.  With a clock
//     (t, lead_act) it consumes from the merged (pending-TP, next-FP) head
//     while the head's action point min(tp_t0, fp_time) - lead_act is
//     before t, on the lanes of mask; each step either walks the lookahead
//     fault cursor to the next visible true positive (coin u < recall, a
//     finite date; tp_t0 = max(0, tm - u_off * window)) or to its death
//     (tp_t0 = inf, tp_ft = nan), or draws the next false prediction (with
//     trust q in {0, 1} one event).  Without a clock it does one such
//     refill: the lookahead walk where mask, one false prediction where
//     fp_mask (the cursors' priming, and the pop of the merged head).
//     Fractional trust (0 < q < 1; the three trust pointers set, else
//     null and the walk is the one above): a true positive is visible
//     only if also its trust coin (counter ctr of the TP-trust stream) is
//     below q, and a false-prediction draw repeats until its trust coin
//     is below q or the stream dies.
//   - strike walk: the stale-fault cascade.  On the lanes of res, while the
//     strike cursor's date is before t (or, with migration, its counter is
//     one of three cancelled ones): a fault within the repair window
//     restarts the repair (t = date + DR, one more fault), then the cursor
//     draws its next fault.
//   - silent walk: the latent strikes of silent-error lanes.  On the lanes
//     of silr, while the strike cursor's date is at or before t, the strike
//     corrupts the state silently (corrupt = min(corrupt, date)), then the
//     cursor draws its next strike.
// Each lane executes the same operations in the same order as the plain
// versions' masked passes (kernels/sim_step.py prediction_walk,
// strike_walk and silent_walk), through the same device advance(), so a
// walk is lane for lane the bits of the one-event kernel looped.
//
// Law variants.  Every kernel comes in two, templated on Indexed: the
// single-law one takes one (law, p1, p2) per launch and stream; the
// law-indexed one (entry points *_indexed) replaces the reference's
// kind="indexed" bodies (the mixed-law sweep) and reads each lane's law code
// and shape slots from three more per-lane arrays.  In the prediction walk
// the fault stream and the false-prediction stream choose apart: the
// indexed entry takes a (law, p1, p2) and a (law_i, s1, s2) pointer triple
// per stream, and a null law_i draws that stream with the scalars (null
// pointers, not more template flags: two instantiations, and the choice is
// uniform over the launch).  Lanes are cell-ordered, so the law, recall and
// window are warp-uniform except at a cell boundary and the per-lane law
// switch diverges little.
//
// Layout: one thread per lane, grid-stride, over flat contiguous (L,)
// arrays (the TPU kernels' (rows, 128) slab layout is not carried over).
// Times are f64, prim / cont / flags / ctr / cancel slots int32, the fault
// count int64, the stream key an int64 bit pattern read as uint64_t, masks
// one byte (torch.bool).  State is updated in place, as the Pallas
// input_output_aliases do.  Kernels use no shared memory and no atomics,
// allocate nothing and launch on the caller's stream; each C entry point
// returns cudaGetLastError().
//
// What bounds them on an H100: the two one-event kernels are elementwise
// with a handful of f64 operations per lane (the transcendental gap only on
// the lanes that draw), so device memory, not arithmetic, is the roofline.
// Kernel 1 moves 156 B per lane in its generating variant (reads 108: prim,
// cont, ctr 4 B each; target, ckend, nf, t, saved, unsaved, pw, W, DR, key,
// mean, horizon 8 B each; writes 48: t, saved, unsaved, pw, tm 8 B each,
// flags, ctr 4 B each) and kernel 2 moves 49 B per lane (reads mask 1, ctr
// 4, tm, key, mean, horizon 8 each; writes ctr 4, tm 8); the law-indexed
// variant reads 20 B more (law 4, s1 8, s2 8) on each lane that draws.  At
// the paper grid's ~10^5 lanes a launch's bytes take a few microseconds at
// 3.35 TB/s, the same order as the launch itself, so each launch is one
// pass over the lanes: coalesced loads (neighbouring threads on
// neighbouring lanes), every intermediate in registers.
// The walks read a lane's record once and write it once whatever the walk's
// length, and most lanes do not walk at all, so they are read in two
// rounds: first what decides whether the lane walks (the masks; with a
// clock t, lead_act, tp_t0, fp_time; in the strike walk t, the cursor and
// the cancel slots), then, as predicated loads (inline PTX, one predicate
// per lane, no branch), the rest of the record of the lanes that walk, all
// in flight together before the first use.  The cursor stays in registers
// for the whole walk and each output is stored once.  The silent walk reads
// even the clock and the cursor date only under silr, since most lanes of a
// sweep are not silent-error lanes.  A walk's time is then
// the latency of its longest warp's chain of draws (each a SplitMix64, a
// log1p or the lognormal's log / cos / exp in f64, dependent on the last),
// not bytes: the bound counts both.
//
// sim_step_slab_prediction_skip, sim_step_slab_strike_walk and
// sim_step_slab_silent_walk are the host trace mode's cursor loops, which the
// reference runs as lax.while_loops with no Pallas kernel
// (src/repro/core/jax_sim.py l.460-469, l.689-716, l.812-829).  There the
// events are host-drawn slabs laid out (events, lanes): row r holds every
// lane's r-th event, so slab[r * n + i] is lane i's event r and neighbouring
// threads read neighbouring addresses while their cursors move in step.
// Each lane walks its own int64 cursor in place, one thread per lane:
//   - prediction skip: on the lanes of mask, advance pi while the window
//     start P0[pi] less lead_act is before t (predictions whose action point
//     has passed);
//   - slab strike walk: first, on the lanes of can (a migration's vacated
//     node), mark the first not yet cancelled row at or after fi whose fault
//     date is ep_ft in the Fcancel slab (rows are sorted, so the search stops
//     at the first later date); then on the lanes of res, while the fault at
//     fi is before t or cancelled: a fault within the repair window rc
//     restarts the repair (t = date + rc, one more fault), then fi moves on;
//   - slab silent walk: on the lanes of silr, while the fault at fi is at or
//     before t, it corrupts the state silently (corrupt = min(corrupt,
//     date)) and fi moves on.
// No cursor passes the slab's last row (the +inf sentinel row every host
// slab ends with).  The walks only compare and add, so a lane's outputs are
// bit for bit those of the plain versions' masked passes
// (kernels/sim_step.py slab_prediction_skip, slab_strike_walk,
// slab_silent_walk).  What bounds them: the mask of every lane, the record
// of the masked lanes, and one slab element per step a lane takes; a step is
// a dependent load, so a walk's time is its longest warp's chain of loads.
//
// Numerics: build with --fmad=false.  Otherwise nvcc contracts
// tm + g, tm - u_off * window and the lognormal exponent into FMAs, and the
// kernels differ in the last bits from their plain PyTorch versions (and
// from the reference).  The Weibull exponent mirrors the reference's pow
// strength reductions (exponent 2 -> x * x, 0.5 -> sqrt).

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

// ---- the walks -------------------------------------------------------- //

// Predicated loads: the value at p where in, else 0.  One predicate per
// lane and no branch, so the compiler issues a lane's loads back to back
// and they are in flight together; the memory clobber keeps them before
// the stores of the same record.
__device__ __forceinline__ double ld_f64(const double* p, bool in) {
  double v;
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n"
      "mov.f64 %0, 0d0000000000000000;\n@q ld.global.f64 %0, [%1];\n}\n"
      : "=d"(v)
      : "l"(p), "r"(static_cast<int>(in))
      : "memory");
  return v;
}

__device__ __forceinline__ int32_t ld_i32(const int32_t* p, bool in) {
  int32_t v;
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n"
      "mov.b32 %0, 0;\n@q ld.global.b32 %0, [%1];\n}\n"
      : "=r"(v)
      : "l"(p), "r"(static_cast<int>(in))
      : "memory");
  return v;
}

__device__ __forceinline__ uint64_t ld_u64(const int64_t* p, bool in) {
  uint64_t v;
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n"
      "mov.b64 %0, 0;\n@q ld.global.b64 %0, [%1];\n}\n"
      : "=l"(v)
      : "l"(p), "r"(static_cast<int>(in))
      : "memory");
  return v;
}

// NaN-propagating minimum, as torch.minimum / jnp.minimum
__device__ __forceinline__ double nan_min(double a, double b) {
  if (a != a || b != b) return a + b;
  return a < b ? a : b;
}

// the canonical quiet NaN (torch's float("nan"))
__device__ __forceinline__ double quiet_nan() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// One stream's law: per launch (law, p1, p2), or per lane where Indexed
// and law_i is not null.
struct LawRef {
  int32_t law;
  double p1, p2;
  const int32_t* law_i;
  const double* s1;
  const double* s2;
};

struct Law {
  int law;
  double p1, p2;
};

template <bool Indexed>
__device__ __forceinline__ Law lane_law(const LawRef& r, int64_t i, bool in) {
  if constexpr (Indexed) {
    if (r.law_i != nullptr) {
      return {ld_i32(r.law_i + i, in), ld_f64(r.s1 + i, in),
              ld_f64(r.s2 + i, in)};
    }
  }
  return {r.law, r.p1, r.p2};
}

struct PredictionArgs {
  const bool* mask;
  const bool* fp_mask;    // null with a clock
  const double* t;        // the clock: null for one refill
  const double* lead_act;
  int32_t* la_ctr;
  double* la_time;
  double* tp_t0;
  double* tp_ft;
  int32_t* tp_ctr;
  int32_t* fp_ctr;
  double* fp_time;
  const int64_t* f_key;
  const double* f_mean;
  const int64_t* tc_key;
  const double* recall;
  const double* window;
  const int64_t* fp_key;
  const double* fp_mean;
  const double* horizon;
  // fractional trust: the TP- and FP-trust stream keys and the lanes' q;
  // all null with trust q in {0, 1}
  const int64_t* tt_key;
  const int64_t* ft_key;
  const double* q_eff;
  LawRef f_law, fp_law;
};

// A lane's trust coins: set (uniform over the launch) when the trust
// pointers are; each coin reads the lane's key and q where it is drawn
// (cached after the first), so a walk holds no registers for them.
struct Trust {
  const int64_t* key;  // the TP- or FP-trust stream's keys, null without
  const double* q;
  int64_t i;
};

// Is ctr's uniform of the lane's trust stream (the high word, as
// kernels/sim_step.py counter_uniform) below its q?
__device__ __forceinline__ bool trusted(const Trust& tr, int32_t ctr) {
  uint32_t hi, lo;
  splitmix64(static_cast<uint64_t>(tr.key[tr.i]), ctr, &hi, &lo);
  return uniform24(hi) < tr.q[tr.i];
}

// The lookahead walk: draw faults until one is a visible true positive
// (the pending-TP slot takes its window start, date and counter) or the
// cursor dies past the horizon (the slot empties: inf / nan).
__device__ __forceinline__ void tp_walk(uint64_t f_key, uint64_t tc_key,
                                        double f_mean, double horizon,
                                        const Law& fl, double recall,
                                        double window, const Trust& tr,
                                        int32_t* lc, double* lt, double* t0,
                                        double* ft, int32_t* tc) {
  for (;;) {
    advance(f_key, lc, lt, f_mean, horizon, fl.law, fl.p1, fl.p2);
    uint32_t w0, w1;
    splitmix64(tc_key, *lc, &w0, &w1);
    if (!isfinite(*lt)) {
      *t0 = INFINITY;
      *ft = quiet_nan();
      return;
    }
    if (uniform24(w0) < recall && (tr.key == nullptr || trusted(tr, *lc))) {
      const double x = *lt - uniform24(w1) * window;
      *t0 = x < 0.0 ? 0.0 : x;  // torch.clamp(min=0): x is finite here
      *ft = *lt;
      *tc = *lc;
      return;
    }
  }
}

// The next false prediction: one draw, or with trust coins draws until one
// is trusted or the stream dies past the horizon.
__device__ __forceinline__ void fp_draw(uint64_t fp_key, double fp_mean,
                                        double horizon, const Law& pl,
                                        const Trust& tr, int32_t* fc,
                                        double* fpt) {
  for (;;) {
    advance(fp_key, fc, fpt, fp_mean, horizon, pl.law, pl.p1, pl.p2);
    if (tr.key == nullptr || !isfinite(*fpt) || trusted(tr, *fc)) return;
  }
}

// A walk's time is its longest chain of dependent draws, so the blocks an
// SM keeps resident count: without the trust coins' code the two
// instantiations took 64 and 76 registers, 4 and 3 blocks of 256 threads
// an SM, and the bounds hold them there (the coins' code would take 70 and
// 80; tools/walk_ab.py measured the walks 4-13% slower then).
template <bool Indexed>
__global__ void __launch_bounds__(kThreads, Indexed ? 3 : 4)
prediction_walk_kernel(int64_t n, PredictionArgs a) {
  const bool until = a.t != nullptr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    // round 1: what decides whether the lane walks
    const bool m = a.mask[i];
    bool walks, mf = false;
    double tt = 0.0, lead = 0.0, t0 = 0.0, fpt = 0.0;
    if (until) {
      tt = a.t[i];
      lead = a.lead_act[i];
      t0 = a.tp_t0[i];
      fpt = a.fp_time[i];
      walks = m && nan_min(t0, fpt) - lead < tt;
    } else {
      mf = a.fp_mask[i];
      walks = m || mf;
    }
    // round 2: the rest of the record, predicated, all in flight together
    int32_t lc = ld_i32(a.la_ctr + i, walks);
    double lt = ld_f64(a.la_time + i, walks);
    double ft = ld_f64(a.tp_ft + i, walks);
    int32_t tc = ld_i32(a.tp_ctr + i, walks);
    int32_t fc = ld_i32(a.fp_ctr + i, walks);
    if (!until) {
      t0 = ld_f64(a.tp_t0 + i, walks);
      fpt = ld_f64(a.fp_time + i, walks);
    }
    const uint64_t f_key = ld_u64(a.f_key + i, walks);
    const uint64_t tc_key = ld_u64(a.tc_key + i, walks);
    const uint64_t fp_key = ld_u64(a.fp_key + i, walks);
    const double f_mean = ld_f64(a.f_mean + i, walks);
    const double fp_mean = ld_f64(a.fp_mean + i, walks);
    const double recall = ld_f64(a.recall + i, walks);
    const double window = ld_f64(a.window + i, walks);
    const double horizon = ld_f64(a.horizon + i, walks);
    const Law fl = lane_law<Indexed>(a.f_law, i, walks);
    const Law fpl = lane_law<Indexed>(a.fp_law, i, walks);
    if (!walks) continue;
    const Trust tp_coin{a.tt_key, a.q_eff, i}, fp_coin{a.ft_key, a.q_eff, i};

    if (until) {
      // consume from the merged head while its action point has passed
      while (nan_min(t0, fpt) - lead < tt) {
        if (t0 <= fpt) {
          tp_walk(f_key, tc_key, f_mean, horizon, fl, recall, window, tp_coin,
                  &lc, &lt, &t0, &ft, &tc);
        } else {
          fp_draw(fp_key, fp_mean, horizon, fpl, fp_coin, &fc, &fpt);
        }
      }
    } else {
      if (mf) fp_draw(fp_key, fp_mean, horizon, fpl, fp_coin, &fc, &fpt);
      if (m) {
        tp_walk(f_key, tc_key, f_mean, horizon, fl, recall, window, tp_coin,
                &lc, &lt, &t0, &ft, &tc);
      }
    }
    a.la_ctr[i] = lc;
    a.la_time[i] = lt;
    a.tp_t0[i] = t0;
    a.tp_ft[i] = ft;
    a.tp_ctr[i] = tc;
    a.fp_ctr[i] = fc;
    a.fp_time[i] = fpt;
  }
}

struct StrikeArgs {
  const bool* res;
  double* t;
  int32_t* sf_ctr;
  double* sf_time;
  int64_t* n_faults;
  const double* DR;
  const int64_t* key;
  const double* mean;
  const double* horizon;
  const int32_t* cancel0;  // the three cancel slots: null without migration
  const int32_t* cancel1;
  const int32_t* cancel2;
  LawRef law;
};

template <bool Indexed>
__global__ void strike_walk_kernel(int64_t n, StrikeArgs a) {
  const bool has_mig = a.cancel0 != nullptr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    // round 1: what decides whether the lane steps
    const bool r = a.res[i];
    double tt = a.t[i];
    double st = a.sf_time[i];
    int32_t sc = a.sf_ctr[i];
    int32_t c0 = -1, c1 = -1, c2 = -1;
    if (has_mig) {
      c0 = a.cancel0[i];
      c1 = a.cancel1[i];
      c2 = a.cancel2[i];
    }
    const bool walks =
        r && (st < tt || (has_mig && (sc == c0 || sc == c1 || sc == c2)));
    // round 2: predicated, all in flight together
    const double dr = ld_f64(a.DR + i, walks);
    int64_t nflt = static_cast<int64_t>(ld_u64(a.n_faults + i, walks));
    const uint64_t key = ld_u64(a.key + i, walks);
    const double mean = ld_f64(a.mean + i, walks);
    const double horizon = ld_f64(a.horizon + i, walks);
    const Law lw = lane_law<Indexed>(a.law, i, walks);
    if (!walks) continue;

    for (;;) {
      const bool cc = has_mig && (sc == c0 || sc == c1 || sc == c2);
      if (!(cc || st < tt)) break;
      if (!cc && st >= tt - dr) {  // a fault during the repair restarts it
        tt = st + dr;
        ++nflt;
      }
      advance(key, &sc, &st, mean, horizon, lw.law, lw.p1, lw.p2);
    }
    a.t[i] = tt;
    a.sf_ctr[i] = sc;
    a.sf_time[i] = st;
    a.n_faults[i] = nflt;
  }
}

struct SilentArgs {
  const bool* silr;
  const double* t;
  int32_t* sf_ctr;
  double* sf_time;
  double* corrupt;
  const int64_t* key;
  const double* mean;
  const double* horizon;
  LawRef law;
};

// Most lanes of a sweep are not silent-error lanes (silr clear), so even the
// clock and the cursor date are read only under silr.
template <bool Indexed>
__global__ void silent_walk_kernel(int64_t n, SilentArgs a) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    // round 1: what decides whether the lane walks
    const bool r = a.silr[i];
    const double tt = ld_f64(a.t + i, r);
    double st = ld_f64(a.sf_time + i, r);
    const bool walks = r && st <= tt;
    // round 2: predicated, all in flight together
    int32_t sc = ld_i32(a.sf_ctr + i, walks);
    double cor = ld_f64(a.corrupt + i, walks);
    const uint64_t key = ld_u64(a.key + i, walks);
    const double mean = ld_f64(a.mean + i, walks);
    const double horizon = ld_f64(a.horizon + i, walks);
    const Law lw = lane_law<Indexed>(a.law, i, walks);
    if (!walks) continue;

    do {  // the strike at or before the clock corrupts silently
      cor = nan_min(cor, st);
      advance(key, &sc, &st, mean, horizon, lw.law, lw.p1, lw.p2);
    } while (st <= tt);
    a.sf_ctr[i] = sc;
    a.sf_time[i] = st;
    a.corrupt[i] = cor;
  }
}

// ---- the host trace mode's slab walks --------------------------------- //

__global__ void slab_prediction_skip_kernel(int64_t n, int64_t rows,
                                            const bool* __restrict__ mask,
                                            const double* __restrict__ t,
                                            const double* __restrict__ lead_act,
                                            const double* __restrict__ P0,
                                            int64_t* __restrict__ pi) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t last = rows - 1;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    if (!mask[i]) continue;
    const double tt = t[i];
    const double lead = lead_act[i];
    const int64_t p0 = pi[i];
    int64_t p = p0;
    while (p < last && P0[p * n + i] - lead < tt) ++p;
    if (p != p0) pi[i] = p;
  }
}

__global__ void slab_strike_walk_kernel(
    int64_t n, int64_t rows, const bool* __restrict__ res,
    double* __restrict__ t, int64_t* __restrict__ fi,
    int64_t* __restrict__ n_faults, const double* __restrict__ rc,
    const double* __restrict__ F, bool* __restrict__ Fcancel,
    const bool* __restrict__ can, const double* __restrict__ ep_ft) {
  const bool has_mig = Fcancel != nullptr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t last = rows - 1;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const bool r = res[i];
    const bool cn = can != nullptr && can[i];
    if (!r && !cn) continue;
    const int64_t f0 = fi[i];
    if (cn) {
      // cancel the vacated node's predicted fault: the first row at or after
      // the cursor with its date and no cancel mark yet
      const double e = ep_ft[i];
      for (int64_t j = f0;; ++j) {
        const double v = F[j * n + i];
        if (v == e && !Fcancel[j * n + i]) {
          Fcancel[j * n + i] = true;
          break;
        }
        if (!(v <= e) || j >= last) break;
      }
    }
    if (!r) continue;
    double tt = t[i];
    double cf = F[f0 * n + i];
    bool cc = has_mig && Fcancel[f0 * n + i];
    if (!((cc || cf < tt) && f0 < last)) continue;
    const double dr = rc[i];
    int64_t nflt = n_faults[i];
    int64_t f = f0;
    do {  // a fault during the repair restarts it; cancelled ones are skipped
      if (!cc && cf >= tt - dr) {
        tt = cf + dr;
        ++nflt;
      }
      ++f;
      cf = F[f * n + i];
      cc = has_mig && Fcancel[f * n + i];
    } while ((cc || cf < tt) && f < last);
    t[i] = tt;
    fi[i] = f;
    n_faults[i] = nflt;
  }
}

__global__ void slab_silent_walk_kernel(int64_t n, int64_t rows,
                                        const bool* __restrict__ silr,
                                        const double* __restrict__ t,
                                        int64_t* __restrict__ fi,
                                        double* __restrict__ corrupt,
                                        const double* __restrict__ F) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t last = rows - 1;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    if (!silr[i]) continue;
    const double tt = t[i];
    int64_t f = fi[i];
    double cf = F[f * n + i];
    if (!(cf <= tt && f < last)) continue;
    double cor = corrupt[i];
    do {  // the fault at or before the clock corrupts silently
      cor = nan_min(cor, cf);
      ++f;
      cf = F[f * n + i];
    } while (cf <= tt && f < last);
    fi[i] = f;
    corrupt[i] = cor;
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

// The prediction walk.  With t (and lead_act) not null: the merged-head
// walk on the lanes of mask, fp_mask null.  With t null: one refill, the
// lookahead walk where mask and one false prediction where fp_mask.
// tt_key, ft_key and q_eff: the trust coins, all null with q in {0, 1}.
extern "C" int sim_step_prediction_walk(
    int64_t n, const bool* mask, const bool* fp_mask, const double* t,
    const double* lead_act, int32_t* la_ctr, double* la_time, double* tp_t0,
    double* tp_ft, int32_t* tp_ctr, int32_t* fp_ctr, double* fp_time,
    const int64_t* f_key, const double* f_mean, const int64_t* tc_key,
    const double* recall, const double* window, const int64_t* fp_key,
    const double* fp_mean, const double* horizon, const int64_t* tt_key,
    const int64_t* ft_key, const double* q_eff, int32_t f_law, double f_p1,
    double f_p2, int32_t fp_law, double fp_p1, double fp_p2, void* stream) {
  if (n <= 0) return 0;
  const PredictionArgs a{
      mask, fp_mask, t, lead_act, la_ctr, la_time, tp_t0, tp_ft, tp_ctr,
      fp_ctr, fp_time, f_key, f_mean, tc_key, recall, window, fp_key, fp_mean,
      horizon, tt_key, ft_key, q_eff,
      LawRef{f_law, f_p1, f_p2, nullptr, nullptr, nullptr},
      LawRef{fp_law, fp_p1, fp_p2, nullptr, nullptr, nullptr}};
  prediction_walk_kernel<false><<<blocks_for(n), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(n, a);
  return static_cast<int>(cudaGetLastError());
}

// The law-indexed prediction walk: each stream takes its scalars (f_law,
// f_p1, f_p2) where its per-lane triple (f_law_i, f_s1, f_s2) is null.
extern "C" int sim_step_prediction_walk_indexed(
    int64_t n, const bool* mask, const bool* fp_mask, const double* t,
    const double* lead_act, int32_t* la_ctr, double* la_time, double* tp_t0,
    double* tp_ft, int32_t* tp_ctr, int32_t* fp_ctr, double* fp_time,
    const int64_t* f_key, const double* f_mean, const int64_t* tc_key,
    const double* recall, const double* window, const int64_t* fp_key,
    const double* fp_mean, const double* horizon, const int64_t* tt_key,
    const int64_t* ft_key, const double* q_eff, int32_t f_law, double f_p1,
    double f_p2, const int32_t* f_law_i, const double* f_s1,
    const double* f_s2, int32_t fp_law, double fp_p1, double fp_p2,
    const int32_t* fp_law_i, const double* fp_s1, const double* fp_s2,
    void* stream) {
  if (n <= 0) return 0;
  const PredictionArgs a{
      mask, fp_mask, t, lead_act, la_ctr, la_time, tp_t0, tp_ft, tp_ctr,
      fp_ctr, fp_time, f_key, f_mean, tc_key, recall, window, fp_key, fp_mean,
      horizon, tt_key, ft_key, q_eff,
      LawRef{f_law, f_p1, f_p2, f_law_i, f_s1, f_s2},
      LawRef{fp_law, fp_p1, fp_p2, fp_law_i, fp_s1, fp_s2}};
  prediction_walk_kernel<true><<<blocks_for(n), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(n, a);
  return static_cast<int>(cudaGetLastError());
}

// The strike walk; cancel0..2 null without migration.
extern "C" int sim_step_strike_walk(
    int64_t n, const bool* res, double* t, int32_t* sf_ctr, double* sf_time,
    int64_t* n_faults, const double* DR, const int64_t* key,
    const double* mean, const double* horizon, const int32_t* cancel0,
    const int32_t* cancel1, const int32_t* cancel2, int32_t law, double p1,
    double p2, void* stream) {
  if (n <= 0) return 0;
  const StrikeArgs a{res,     t,       sf_ctr,  sf_time, n_faults,
                     DR,      key,     mean,    horizon, cancel0,
                     cancel1, cancel2, LawRef{law, p1, p2, nullptr, nullptr, nullptr}};
  strike_walk_kernel<false><<<blocks_for(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(n, a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sim_step_strike_walk_indexed(
    int64_t n, const bool* res, double* t, int32_t* sf_ctr, double* sf_time,
    int64_t* n_faults, const double* DR, const int64_t* key,
    const double* mean, const double* horizon, const int32_t* cancel0,
    const int32_t* cancel1, const int32_t* cancel2, const int32_t* law_i,
    const double* s1, const double* s2, void* stream) {
  if (n <= 0) return 0;
  const StrikeArgs a{res,     t,       sf_ctr,  sf_time, n_faults,
                     DR,      key,     mean,    horizon, cancel0,
                     cancel1, cancel2, LawRef{kLawExponential, 0.0, 0.0, law_i, s1, s2}};
  strike_walk_kernel<true><<<blocks_for(n), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(n, a);
  return static_cast<int>(cudaGetLastError());
}

// The silent walk.
extern "C" int sim_step_silent_walk(int64_t n, const bool* silr,
                                    const double* t, int32_t* sf_ctr,
                                    double* sf_time, double* corrupt,
                                    const int64_t* key, const double* mean,
                                    const double* horizon, int32_t law,
                                    double p1, double p2, void* stream) {
  if (n <= 0) return 0;
  const SilentArgs a{silr, t,    sf_ctr,  sf_time, corrupt,
                     key,  mean, horizon, LawRef{law, p1, p2, nullptr, nullptr, nullptr}};
  silent_walk_kernel<false><<<blocks_for(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(n, a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sim_step_silent_walk_indexed(
    int64_t n, const bool* silr, const double* t, int32_t* sf_ctr,
    double* sf_time, double* corrupt, const int64_t* key, const double* mean,
    const double* horizon, const int32_t* law_i, const double* s1,
    const double* s2, void* stream) {
  if (n <= 0) return 0;
  const SilentArgs a{silr, t,    sf_ctr,  sf_time, corrupt,
                     key,  mean, horizon, LawRef{kLawExponential, 0.0, 0.0, law_i, s1, s2}};
  silent_walk_kernel<true><<<blocks_for(n), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(n, a);
  return static_cast<int>(cudaGetLastError());
}

// The host trace mode's slab walks: n lanes, slabs of rows x n, int64
// cursors.  Fcancel, can and ep_ft are null without migration.
extern "C" int sim_step_slab_prediction_skip(int64_t n, int64_t rows,
                                             const bool* mask, const double* t,
                                             const double* lead_act,
                                             const double* P0, int64_t* pi,
                                             void* stream) {
  if (n <= 0) return 0;
  slab_prediction_skip_kernel<<<blocks_for(n), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      n, rows, mask, t, lead_act, P0, pi);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sim_step_slab_strike_walk(int64_t n, int64_t rows,
                                         const bool* res, double* t,
                                         int64_t* fi, int64_t* n_faults,
                                         const double* rc, const double* F,
                                         bool* Fcancel, const bool* can,
                                         const double* ep_ft, void* stream) {
  if (n <= 0) return 0;
  slab_strike_walk_kernel<<<blocks_for(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      n, rows, res, t, fi, n_faults, rc, F, Fcancel, can, ep_ft);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sim_step_slab_silent_walk(int64_t n, int64_t rows,
                                         const bool* silr, const double* t,
                                         int64_t* fi, double* corrupt,
                                         const double* F, void* stream) {
  if (n <= 0) return 0;
  slab_silent_walk_kernel<<<blocks_for(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      n, rows, silr, t, fi, corrupt, F);
  return static_cast<int>(cudaGetLastError());
}
