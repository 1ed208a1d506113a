// Event-driven ensemble evolve on Hopper (sm_90a), float and double.
//
// Replaces: armadillocudalinearinterpolation_tpu/model/evolve_pallas.py::
// _evolve_kernel, the whole event loop of a block of realisations, with its
// certified window (select_event_windowed) and firing-order log.  The plain
// PyTorch versions of the same function are
// armadillocudalinearinterpolation_torch/model/evolve.py::evolve_ensemble
// (every lane) and model/evolve_batched.py::evolve_ensemble_batched (the
// window).
//
// What bounds it: each event costs every evaluated lane a fire decision
// (one pow) and a Newton root-find for the lanes that fire (two exp per
// step), and every lane the closed-form advance (two exp and a division,
// all in full precision, as the plain version rounds them); and each event
// needs one block-wide argmin over (time, index) pairs before any lane can
// advance.  A row runs ~500 events one after another at N=512, ~3400 at
// N=4096.  With one pass and one barrier an event (below), the pass takes
// about two thirds of an event at config 4's 64-row launches (clock64
// readings on an H100: the reduction with its wait on the pass's last
// results a quarter, the bookkeeping 8%), so the lanes' arithmetic and the
// root-find's chain now bound it; rows of 64 or 128 threads (the fast
// family) pay each warp's copy of the bookkeeping.  So the design cuts
// the lane work per event and keeps the serial part short:
// - one pass and one barrier an event (run_events): the reduction leaves
//   the event (dt, j) in every thread; every thread classifies it, moves t
//   on, takes the stop test and finds the next event's window itself, so
//   no thread waits on a bookkeeping thread; then one pass advances each
//   lane by the event and, on the values still in registers, scores it
//   for the next one (its firing time in the window, its certificate
//   outside).  The per-warp winners alternate between two slots, so one
//   barrier is enough (block_argmin).  Thread 0 alone writes the next copy
//   of the tracked indices (two copies, by the event's parity), the
//   trajectories' times and the logs.
// - the certified window (W > 0): the root-find runs on at most W lanes
//   around the row's tracked spikes, cyclically.  A row whose initial
//   tracked indices lie in one run of W lanes from (min(last_ind) - pad_w)
//   mod N keeps that one run; any other row takes one run of Wm = max(W /
//   M, 1) lanes from (last_ind[m] - pad_m) mod N per tracked spike.  Every
//   other lane only adds its ODE-comparison bound to a block minimum (one
//   division: the bound log(cap - v) - log(cap - vth) is taken as the log
//   of the smallest ratio, one log per row).  If the windowed event time is
//   at most the bound, it is the global event; otherwise the row evaluates
//   every lane for that event, through the same select_full as W = 0.
//   The runs per tracked spike are where the JAX package's
//   select_event_windowed keeps its one run: a tracked spike that never
//   fires again (the fast wave family keeps one at index 0 while its two
//   live fronts run from lanes 231-256 to 444-468) drags that run off the
//   fronts, and 92% of the family's events fell back.  The geometry is
//   chosen once a row, and each geometry has its own event loop
//   (run_events), so a one-run row runs the one-run code alone: the runs'
//   union would leave the certificate more lanes than the threads' stride,
//   and a choice at every event cost config 4's f32 rows 5% on an H100.
//   In a row of runs, every warp ranks the runs' starts into its own
//   slot of shared memory (row.win) after each event that moves a
//   tracked spike; the pass takes the runs' union side by side, then the
//   gaps between them, each thread stepping from stretch to stretch, so
//   no lane tests which run it is in (such a test cost config 3's K1
//   30%).  Each CTA owns one row, so the window is anchored per row and
//   moves with it: no persistent rolls, no hysteresis, no block-wide
//   fallback.
// - the kick table: w(d) = (a1 e^{-b1 d dx} - a2 e^{-b2 d dx}) dx for
//   d <= N/2, computed once per row with the very expression the per-lane
//   kick used, so the advance reads it instead of two exp per lane.
//
// Layout: one CTA per row (one point x one realisation), as in the CUDA
// original's EvolveKernel; threads stride over the lanes, so N need not
// equal blockDim.  The row's v, s, beta and kick table (3N + N/2 + 1
// values) stay in shared memory where they fit; where they do not (large
// N), the row keeps them in a (rows, 3N + N/2 + 1) scratch in device memory
// that the wrapper allocates (resident rows x row bytes stays in the 50 MB
// L2), and the same kernel body runs on those pointers.  The argmin is a
// warp minimum (redux.sync) on keys that order (time, index) as the plain
// argmin does, then, after the one barrier, every warp's minimum over the
// per-warp winners.
//
// Firing-order log (evolve_pallas.py:148-154,475-482): given a non-null
// `sched`, thread 0 writes sched[row * E + k] = j for the row's event
// k < E, so the log holds only the lanes the row really fired;
// a row with more than E events keeps counting n_events and logs nothing
// past column E - 1 (the replay rejects it through n_events > E).  The
// wrapper zero-fills the log.  Given a non-null `times` beside it (the time
// log), the same thread writes the event's dt, as the row took it, in fp64
// at times[row * E + k]: the exact tangent replay reads these times in
// place of its own root-find.
//
// Semantics follow model/events.py, model/evolve.py and
// model/evolve_batched.py operation by operation (the shared per-lane
// arithmetic is in events.cuh).

#include <stdint.h>

#include "events.cuh"

namespace {

// A row that has not stopped after this many events is stopped unaccepted
// rather than left to spin: t grows by a nonnegative dt per event, and a
// physical row needs a few thousand.
constexpr int kEventGuard = 1 << 24;

__device__ __forceinline__ float xlog(float x) { return logf(x); }
__device__ __forceinline__ double xlog(double x) { return ::log(x); }

// (time, index) order of torch.argmin: NaN first, then smaller time, then
// lower index.
template <typename T>
__device__ __forceinline__ bool before(T ta, int ia, T tb, int ib) {
  const bool na = isnan(ta), nb = isnan(tb);
  if (na || nb) return na && (!nb || ia < ib);
  return ta < tb || (ta == tb && ia < ib);
}

// torch.amin's minimum: NaN if either is NaN
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return isnan(a) ? a : ((isnan(b) || b < a) ? b : a);
}

// torch.maximum against a number that is not NaN: a NaN stays
template <typename T>
__device__ __forceinline__ T nan_max(T x, T lo) {
  return (isnan(x) || x > lo) ? x : lo;
}

// Keys whose unsigned order is the order of the warp's minima: a time or
// certificate ratio that is not NaN is +0 or more (event_time returns |t|
// plus a nonnegative number; a ratio is positive, +inf or 1), so its bits
// plus one order as the number, and NaN takes 0, before every number.
__device__ __forceinline__ unsigned order_key(float x) {
  return isnan(x) ? 0u : __float_as_uint(x) + 1u;
}
__device__ __forceinline__ unsigned long long order_key(double x) {
  return isnan(x) ? 0ull : (unsigned long long)__double_as_longlong(x) + 1ull;
}
__device__ __forceinline__ float key_value(unsigned k, float) {
  return __uint_as_float(k - 1u);
}
__device__ __forceinline__ double key_value(unsigned long long k, double) {
  return __longlong_as_double((long long)(k - 1ull));
}

// The warp's unsigned minimum, in every lane (a 64-bit key by its high
// word, then its low word among the lanes that hold that high word).
__device__ __forceinline__ unsigned warp_min(unsigned x) {
  return __reduce_min_sync(0xffffffffu, x);
}
__device__ __forceinline__ unsigned long long warp_min(unsigned long long x) {
  const unsigned hi = __reduce_min_sync(0xffffffffu, (unsigned)(x >> 32));
  const unsigned lo = __reduce_min_sync(
      0xffffffffu, (unsigned)(x >> 32) == hi ? (unsigned)x : 0xffffffffu);
  return ((unsigned long long)hi << 32) | lo;
}

// (time, index) argmin (before()'s order) and NaN-first minimum of r
// (nan_min()'s) over a warp, in every lane, on the keys: the lowest time
// key, then the lowest index among the lanes that hold it.  A NaN time
// keeps its own bits (the winner's lane sends it); a NaN bound only fails
// the certificate, so any NaN will do.
template <typename T>
__device__ __forceinline__ void warp_argmin(T& t, int& i, T& r) {
  const auto kt = order_key(t);
  const auto mt = warp_min(kt);
  const int mi = (int)__reduce_min_sync(
      0xffffffffu, kt == mt ? (unsigned)i : 0xffffffffu);
  const auto mr = warp_min(order_key(r));
  if (mt == 0)
    t = __shfl_sync(0xffffffffu, t,
                    __ffs(__ballot_sync(0xffffffffu, i == mi && kt == mt)) -
                        1);
  else
    t = key_value(mt, t);
  i = mi;
  r = mr == 0 ? T(NAN) : key_value(mr, r);
}

// The out-of-window certificate of one lane as a ratio: its crossing time
// is at least log(ratio) (model/evolve_batched.py::certificate_ratio).
// Between kicks v' <= -v + I + max(s, 0), so with cap = I + max(s, 0) the
// lane cannot reach vth before log((cap - v) / (cap - vth)); never (+inf)
// if cap <= vth; and the bound needs beta > 0 (else ratio 1, bound 0).
template <typename T>
__device__ __forceinline__ T certificate_ratio(T v, T s, T b, T drive, T vth,
                                               T floor) {
  const T cap = drive + nan_max(s, T(0));
  const T denom = cap - vth;
  const T r = denom > T(0) ? nan_max(cap - v, floor) / nan_max(denom, floor)
                           : T(INFINITY);
  return b > T(0) ? r : T(1);
}

// w(d) dx for ring distance d: the expression the per-lane kick computes
template <typename T>
__device__ __forceinline__ T kick_weight(int d, const Consts& c) {
  const T dx = T(c.dx);
  const T dist = T(d) * dx;
  return (T(c.a1) * xexp(T(c.neg_b1) * dist)
          - T(c.a2) * xexp(T(c.neg_b2) * dist)) * dx;
}

// Warps a CTA may have: 1024 threads for float, 512 for double (whose
// registers leave room for no more); the per-warp tables hold this many,
// so that two config-4 rows of doubles still share an SM's shared memory.
template <typename T>
__host__ __device__ constexpr int max_warps() {
  return sizeof(T) == 8 ? 16 : 32;
}

// The row's state: v, s, beta and the kick table (shared or device memory)
// and the small shared part: the trajectories' times and crossing indices
// (thread 0's), two copies of the tracked indices and crossed flags (the
// event's parity: event k reads copy k & 1 and thread 0 writes copy
// (k + 1) & 1), two slots of per-warp winners (the reduction's parity)
// and each warp's M ranked run starts.
template <typename T>
struct Row {
  T *v, *s, *b, *w;
  T *last_time, *crossed_time, *red_t, *red_r;
  int *ind, *crossed, *crossed_ind, *red_i, *win;
};

// The block's (time, index) argmin of the threads' (bt, bi) and NaN-first
// minimum of their r, in every thread, with one barrier: each warp's
// winner goes to slot ph, and after the barrier every warp reduces the
// per-warp winners itself.  A warp writes slot ph again two reductions
// later, after the next barrier, which no warp passes before it has read
// this one; ph flips.
template <typename T>
__device__ __forceinline__ void block_argmin(T& bt, int& bi, T& r,
                                             const Row<T>& row, int& ph) {
  const int warp = threadIdx.x >> 5, lane_id = threadIdx.x & 31;
  const int nwarps = (blockDim.x + 31) >> 5;
  warp_argmin(bt, bi, r);
  constexpr int kW = max_warps<T>();
  T* rt = row.red_t + kW * ph;
  T* rr = row.red_r + kW * ph;
  int* ri = row.red_i + kW * ph;
  if (lane_id == 0) {
    rt[warp] = bt;
    ri[warp] = bi;
    rr[warp] = r;
  }
  __syncthreads();
  bt = lane_id < nwarps ? rt[lane_id] : T(INFINITY);
  bi = lane_id < nwarps ? ri[lane_id] : 0x7fffffff;
  r = lane_id < nwarps ? rr[lane_id] : T(INFINITY);
  warp_argmin(bt, bi, r);
  ph ^= 1;
}

// One lane's part of an event: where kAdvance, the analytic advance by
// (dt, j) (emt = e^{-dt}), the reset of the firing lane and the ring kick,
// stored; then, on the values in registers, its score for the next event:
// its firing time (kTime) into (bt, bi), lowest index on ties, else its
// certificate ratio into r.
template <typename T, bool kAdvance, bool kTime>
__device__ __forceinline__ void visit(const Row<T>& row, int i, int N, T dt,
                                      T emt, int j, const Consts& c, T& bt,
                                      int& bi, T& r) {
  T vi = row.v[i], si = row.s[i];
  const T bi_ = row.b[i];
  if (kAdvance) {
    const T drive = T(c.drive);
    T vn = vi * emt + drive * (T(1) - emt)
           + si * emt / (T(1) - bi_) * (xexp((T(1) - bi_) * dt) - T(1));
    if (i == j) vn = T(0);
    const int d = abs(i - j);
    si = si * xexp(-bi_ * dt) + bi_ * row.w[min(d, N - d)];
    vi = vn;
    row.v[i] = vi;
    row.s[i] = si;
  }
  if (kTime) {
    const T ti = event_time(vi, si, bi_, c);
    if (before(ti, i, bt, bi)) {
      bt = ti;
      bi = i;
    }
  } else {
    const T floor = sizeof(T) == 8 ? T(1e-300) : T(1e-30);
    r = nan_min(r, certificate_ratio(vi, si, bi_, T(c.drive), T(c.vth),
                                     floor));
  }
}

// visit() over lanes [from, to) of the ring (unwrapped, below 2N): the
// thread takes every blockDim.x-th lane from offset k, and k carries on to
// the next stretch, so that consecutive stretches spread over the threads
// as one strided loop's lanes would.
template <typename T, bool kAdvance, bool kTime>
__device__ __forceinline__ void visit_run(const Row<T>& row, int from,
                                          int to, int& k, int N, T dt, T emt,
                                          int j, const Consts& c, T& bt,
                                          int& bi, T& r) {
  const int len = to - from;
  for (; k < len; k += blockDim.x) {
    int i = from + k;
    if (i >= N) i -= N;
    visit<T, kAdvance, kTime>(row, i, N, dt, emt, j, c, bt, bi, r);
  }
  if (len > 0) k -= len;
}

// The window's geometry: every lane timed (W = 0); the one run of W lanes
// from `start`; or the runs of Wm lanes from each warp's ranked starts.
constexpr int kAll = 0, kOneRun = 1, kRuns = 2;

// One pass over every lane of the row in the next event's geometry: each
// lane is advanced by (dt, j) where kAdvance and scored for the next event
// into (bt, bi, r).  Each lane is visited once, so the pass may own it in
// any thread: the window's lanes first, spread evenly over the threads,
// then the others.  kRuns: the runs' union from the lowest start, each run
// clipped to what the runs before it left (a lane in two runs is one
// lane), then the gaps between them once round the ring.  Each of the two
// is one loop, whose threads step from stretch to stretch on their own, so
// that a warp whose lanes fall in two runs still takes the root-find
// together; no lane tests which run it is in (such a test cost config 3's
// K1 30%).
template <typename T, int kGeom, bool kAdvance>
__device__ __forceinline__ void pass(const Row<T>& row, int N, int M, int W,
                                     int start, const int* ws, int Wm, T dt,
                                     int j, const Consts& c, T& bt, int& bi,
                                     T& r) {
  const T emt = kAdvance ? xexp(-dt) : T(1);
  bt = T(INFINITY);
  bi = 0x7fffffff;
  r = T(INFINITY);
  int k = threadIdx.x;
  if (kGeom == kAll) {
    visit_run<T, kAdvance, true>(row, 0, N, k, N, dt, emt, j, c, bt, bi, r);
  } else if (kGeom == kOneRun) {
    visit_run<T, kAdvance, true>(row, start, start + W, k, N, dt, emt, j, c,
                                 bt, bi, r);
    visit_run<T, kAdvance, false>(row, start + W, start + N, k, N, dt, emt,
                                  j, c, bt, bi, r);
  } else {
    // stretch n of the union is [from, to) (unwrapped, empty where to <=
    // from); k - base is the thread's place in it
    const int last = ws[0] + N;
    int n = 0, base = 0, end = ws[0];
    int from = ws[0], to = min(ws[0] + Wm, last);
    for (;; k += blockDim.x) {
      while (k - base >= max(to - from, 0)) {
        base += max(to - from, 0);
        end = max(end, to);
        if (++n == M) break;
        from = max(ws[n], end);
        to = min(ws[n] + Wm, last);
      }
      if (n == M) break;
      int i = from + (k - base);
      if (i >= N) i -= N;
      visit<T, kAdvance, true>(row, i, N, dt, emt, j, c, bt, bi, r);
    }
    // gap n runs from the union's end so far to the next run's start
    k -= base;
    n = 0;
    base = 0;
    from = min(ws[0] + Wm, last);
    to = M > 1 ? ws[1] : last;
    for (;; k += blockDim.x) {
      while (k - base >= max(to - from, 0)) {
        base += max(to - from, 0);
        if (++n == M) break;
        from = max(from, min(ws[n] + Wm, last));
        to = n + 1 < M ? ws[n + 1] : last;
      }
      if (n == M) break;
      int i = from + (k - base);
      if (i >= N) i -= N;
      visit<T, kAdvance, false>(row, i, N, dt, emt, j, c, bt, bi, r);
    }
  }
}

// The event over every lane, on the state before its advance: the
// fallback of W > 0.
template <typename T>
__device__ void select_full(const Row<T>& row, int N, const Consts& c,
                            T& bt, int& bi, T& r, int& ph) {
  bt = T(INFINITY);
  bi = 0x7fffffff;
  r = T(INFINITY);
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const T ti = event_time(row.v[i], row.s[i], row.b[i], c);
    if (before(ti, i, bt, bi)) {
      bt = ti;
      bi = i;
    }
  }
  block_argmin(bt, bi, r, row, ph);
}

// x mod N, in [0, N); one add or subtract where x lies in [-N, 2N).
__device__ __forceinline__ int ring(int x, int N) {
  if (x < 0)
    x += N;
  else if (x >= N)
    x -= N;
  if ((unsigned)x >= (unsigned)N) {  // from a tracked index outside [0, N)
    x %= N;
    if (x < 0) x += N;
  }
  return x;
}

// Tracked index m after the event: li[m], or j where the event moved
// trajectory mm (mm < 0: none moved).
__device__ __forceinline__ int tracked(const int* li, int m, int mm, int j) {
  return m == mm ? j : li[m];
}

// The M tracked spikes' run starts in ascending order (ties in spike
// order) into the warp's own ws, each lane ranking its spikes' runs
// against all M; the warp's lanes read them after the __syncwarp.
__device__ __forceinline__ void rank_windows(int* ws, const int* li, int mm,
                                             int j, int N, int M,
                                             int pad_m) {
  for (int m = threadIdx.x & 31; m < M; m += 32) {
    const int s = ring(tracked(li, m, mm, j) - pad_m, N);
    int rank = 0;
    for (int q = 0; q < M; ++q) {
      const int sq = ring(tracked(li, q, mm, j) - pad_m, N);
      rank += sq < s || (sq == s && q < m);
    }
    ws[rank] = s;
  }
  __syncwarp();
}

// The start of the one run of W lanes: pad_w lanes before the lowest
// tracked index, cyclic.
__device__ __forceinline__ int one_run_start(const int* li, int mm, int j,
                                             int N, int M, int pad_w) {
  int lo = tracked(li, 0, mm, j);
  for (int m = 1; m < M; ++m) lo = min(lo, tracked(li, m, mm, j));
  return ring(lo - pad_w, N);
}

// Whether the one run of W lanes from pad_w lanes before the lowest tracked
// index holds every tracked index.
__device__ __forceinline__ bool one_run_holds(const int* li, int N, int M,
                                              int W, int pad_w) {
  const int start = one_run_start(li, -1, 0, N, M, pad_w);
  bool holds = true;
  for (int m = 0; m < M; ++m) holds = holds && ring(li[m] - start, N) < W;
  return holds;
}

// Elements of a row's v, s, beta and kick table.
__host__ __device__ __forceinline__ size_t row_elems(int N) {
  return 3 * (size_t)N + (size_t)(N / 2 + 1);
}

// What a row's event loop leaves: its events and fallbacks, and whether
// every trajectory crossed.
struct RowEnd {
  int events, fallbacks;
  bool accept;
};

// The row's event loop, one pass and one barrier an event: the reduction
// gives every thread the event (dt, j); every thread classifies it, moves
// t on and takes the stop test on its own (the same numbers in every
// thread, so the stop is uniform), and finds the next event's window from
// the tracked indices as the event leaves them; then one pass advances
// each lane by the event and scores it for the next one.  Thread 0 alone
// writes the next copy of the tracked indices, the trajectories' times and
// the logs.  The row's first event scores the initial state.
template <typename T, int kGeom>
__device__ __forceinline__ RowEnd run_events(const Row<T>& row, int row_id,
                                             int N, int M, int W, int pad_w,
                                             int Wm, int pad_m,
                                             const Consts& c,
                                             int* __restrict__ sched, int E,
                                             double* __restrict__ times) {
  const int tid = threadIdx.x;
  const T T_h = T(c.t_horizon), two_T = T(2) * T(c.t_horizon);
  int* ws = row.win + (tid >> 5) * M;
  int start = 0;
  if (kGeom == kOneRun) start = one_run_start(row.ind, -1, 0, N, M, pad_w);
  if (kGeom == kRuns) rank_windows(ws, row.ind, -1, 0, N, M, pad_m);
  T bt, r;
  int bi;
  pass<T, kGeom, false>(row, N, M, W, start, ws, Wm, T(0), -1, c, bt, bi, r);
  T t = T(0);
  int nev = 0, nfb = 0, n_crossed = 0, ph = 0;
  for (;;) {
    // the row's event (dt, j): lowest index on ties; the windowed one where
    // it is at most the log of the other lanes' smallest certificate ratio
    // (a NaN bound fails: the full pass would put a NaN time first), else
    // the event over every lane
    block_argmin(bt, bi, r, row, ph);
    if (kGeom != kAll && !(bt <= xlog(r))) {
      select_full(row, N, c, bt, bi, r, ph);
      ++nfb;
    }
    const T dt = bt;
    const int j = bi;

    // bookkeeping: the nearest trajectory (lowest id on ties), recorded as
    // its last firing before T or its first after it unless it crossed
    // (model/events.py::classify_event), and the stop test; the same pass
    // over the copy finds, for one run, the lowest tracked index and the
    // lowest of the others, whichever trajectory the event moves
    const int* li = row.ind + (nev & 1) * M;
    const int* cr = row.crossed + (nev & 1) * M;
    int mm = 0, dmin = abs(j - li[0]);
    bool open = !cr[0];
    int lo1 = li[0], at1 = 0, lo2 = 0x7fffffff;
    for (int m = 1; m < M; ++m) {
      const int lm = li[m], dm = abs(j - lm);
      const bool om = !cr[m];
      if (dm < dmin) {
        dmin = dm;
        mm = m;
        open = om;
      }
      if (kGeom == kOneRun) {
        if (lm < lo1) {
          lo2 = lo1;
          lo1 = lm;
          at1 = m;
        } else {
          lo2 = min(lo2, lm);
        }
      }
    }
    t = t + dt;
    const bool crosses = open && t > T_h;
    const bool moves = open && !crosses;
    const bool stop = n_crossed + crosses == M || !(t < two_T) ||
                      nev + 1 >= kEventGuard;

    // the next event's window, from the tracked indices the event leaves;
    // where it moves none, the window stays
    if (moves && !stop) {
      if (kGeom == kOneRun)
        start = ring(min(j, at1 == mm ? lo2 : lo1) - pad_w, N);
      if (kGeom == kRuns) rank_windows(ws, li, mm, j, N, M, pad_m);
    }
    if (tid == 0) {
      int* ni = row.ind + ((nev + 1) & 1) * M;
      int* nc = row.crossed + ((nev + 1) & 1) * M;
      for (int m = 0; m < M; ++m) {
        ni[m] = li[m];
        nc[m] = cr[m];
      }
      if (moves) {
        ni[mm] = j;
        row.last_time[mm] = t;
      } else if (crosses) {
        nc[mm] = 1;
        row.crossed_ind[mm] = j;
        row.crossed_time[mm] = t;
      }
      // firing-order log: event k = nev
      if (sched != nullptr && nev < E) sched[(size_t)row_id * E + nev] = j;
      if (times != nullptr && nev < E) times[(size_t)row_id * E + nev] = dt;
    }
    ++nev;
    n_crossed += crosses;
    if (stop) break;
    pass<T, kGeom, true>(row, N, M, W, start, ws, Wm, dt, j, c, bt, bi, r);
  }
  return RowEnd{nev, nfb, n_crossed == M};
}

template <typename T, bool kRowInGlobal>
__global__ void evolve_kernel(const T* __restrict__ v0,
                              const T* __restrict__ s0,
                              const int* __restrict__ init_ind,
                              const T* __restrict__ beta, int R, int N, int M,
                              int W, int pad_w, int Wm, int pad_m,
                              int beta_per_row, Consts c,
                              int* __restrict__ last_ind_out,
                              T* __restrict__ last_time_out,
                              int* __restrict__ crossed_ind_out,
                              T* __restrict__ crossed_time_out,
                              bool* __restrict__ accept_out,
                              int* __restrict__ n_events_out,
                              int* __restrict__ sched, int E,
                              double* __restrict__ times,
                              T* __restrict__ row_scratch,
                              int* __restrict__ fallbacks_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row_id = blockIdx.x;
  T* big = kRowInGlobal ? row_scratch + (size_t)row_id * row_elems(N)
                        : reinterpret_cast<T*>(smem);
  T* small = kRowInGlobal ? reinterpret_cast<T*>(smem) : big + row_elems(N);
  Row<T> row;
  row.v = big;
  row.s = row.v + N;
  row.b = row.s + N;
  row.w = row.b + N;                       // N/2 + 1 kick weights
  row.last_time = small;
  row.crossed_time = row.last_time + M;
  constexpr int kW = max_warps<T>();
  row.red_t = row.crossed_time + M;        // 2 x kW per-warp winners
  row.red_r = row.red_t + 2 * kW;          // 2 x kW per-warp bounds
  row.ind = reinterpret_cast<int*>(row.red_r + 2 * kW);  // 2 x M
  row.crossed = row.ind + 2 * M;           // 2 x M
  row.crossed_ind = row.crossed + 2 * M;
  row.red_i = row.crossed_ind + M;         // 2 x kW
  row.win = row.red_i + 2 * kW;            // kW warps x M ranked starts

  const int p = row_id / R, r = row_id % R;
  const int tid = threadIdx.x, nthr = blockDim.x;

  for (int i = tid; i < N; i += nthr) {
    row.v[i] = v0[(size_t)p * N + i];
    row.s[i] = s0[(size_t)p * N + i];
    row.b[i] = beta[(size_t)(beta_per_row ? row_id : r) * N + i];
  }
  for (int d = tid; d <= N / 2; d += nthr) row.w[d] = kick_weight<T>(d, c);
  const T two_T = T(2) * T(c.t_horizon);
  if (tid == 0) {
    for (int m = 0; m < M; ++m) {
      row.ind[m] = row.crossed_ind[m] = init_ind[(size_t)p * M + m];
      row.last_time[m] = T(0);
      row.crossed_time[m] = two_T;
      row.crossed[m] = 0;
    }
  }
  __syncthreads();

  // the row's window, decided once from its initial tracked indices: the
  // one run where it holds them, else one run per tracked spike
  RowEnd end;
  if (W == 0)
    end = run_events<T, kAll>(row, row_id, N, M, W, pad_w, Wm, pad_m, c,
                              sched, E, times);
  else if (one_run_holds(row.ind, N, M, W, pad_w))
    end = run_events<T, kOneRun>(row, row_id, N, M, W, pad_w, Wm, pad_m, c,
                                 sched, E, times);
  else
    end = run_events<T, kRuns>(row, row_id, N, M, W, pad_w, Wm, pad_m, c,
                               sched, E, times);

  if (tid == 0) {
    const int* li = row.ind + (end.events & 1) * M;
    for (int m = 0; m < M; ++m) {
      const size_t o = (size_t)row_id * M + m;
      last_ind_out[o] = li[m];
      last_time_out[o] = row.last_time[m];
      crossed_ind_out[o] = row.crossed_ind[m];
      crossed_time_out[o] = row.crossed_time[m];
    }
    accept_out[row_id] = end.accept;
    n_events_out[row_id] = end.events;
    if (fallbacks_out != nullptr) fallbacks_out[row_id] = end.fallbacks;
  }
}

// Dynamic shared memory of one CTA; model/evolve_cuda.py::row_fits_shared
// counts the same arrays.
template <typename T>
size_t smem_bytes(int N, int M, bool row_in_global) {
  const size_t kW = max_warps<T>();
  const size_t small = (2 * (size_t)M + 4 * kW) * sizeof(T)
                       + (5 * (size_t)M + 2 * kW + kW * M) * sizeof(int);
  return small + (row_in_global ? 0 : row_elems(N) * sizeof(T));
}

template <typename T>
int launch(const void* v0, const void* s0, const void* init_ind,
           const void* beta, void* last_ind, void* last_time,
           void* crossed_ind, void* crossed_time, void* accept,
           void* n_events, void* sched, void* times, void* row_scratch,
           void* fallbacks,
           int P, int R, int N, int M, int E, int W, int pad_b,
           int beta_per_row, int threads, const Consts& c, void* stream) {
  if (P < 1 || R < 1 || N < 1 || M < 1 || (sched != nullptr && E < 1) ||
      (times != nullptr && sched == nullptr) ||
      W < 0 || W >= N || pad_b < 0 || pad_b >= N || threads < 32 ||
      threads > 32 * max_warps<T>() || threads % 32)
    return (int)cudaErrorInvalidValue;
  const bool global = row_scratch != nullptr;
  const size_t shmem = smem_bytes<T>(N, M, global);
  auto kernel = global ? evolve_kernel<T, true> : evolve_kernel<T, false>;
  const int err = set_shared_memory(kernel, shmem);
  if (err != 0) return err;
  const long long rows = (long long)P * R;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // each tracked spike's window: model/evolve_batched.py::window_lanes and
  // window_pad
  const int Wm = W / M > 1 ? W / M : 1, pad_m = Wm / 4 < 64 ? Wm / 4 : 64;
  kernel<<<(unsigned)rows, threads, shmem, (cudaStream_t)stream>>>(
      static_cast<const T*>(v0), static_cast<const T*>(s0),
      static_cast<const int*>(init_ind), static_cast<const T*>(beta), R, N,
      M, W, pad_b, Wm, pad_m, beta_per_row, c,
      static_cast<int*>(last_ind),
      static_cast<T*>(last_time), static_cast<int*>(crossed_ind),
      static_cast<T*>(crossed_time), static_cast<bool*>(accept),
      static_cast<int*>(n_events), static_cast<int*>(sched), E,
      static_cast<double*>(times), static_cast<T*>(row_scratch),
      static_cast<int*>(fallbacks));
  return (int)cudaGetLastError();
}

}  // namespace

// times: NULL, or P*R*E doubles beside a non-null sched (the time log).
// row_scratch: NULL keeps each row in shared memory; else P*R*(3N + N/2 +
// 1) values of device memory for the rows.  W = 0: every lane; else the
// certified window: W lanes from pad_b lanes before the row's lowest
// tracked index in a row whose initial tracked indices they hold, else
// max(W / M, 1) lanes from min(64, max(W / M, 1) / 4) lanes before each
// tracked index.
// fallbacks: NULL, or P*R ints, each row's count of windowed events that
// fell back to every lane.  beta_per_row: 0 = beta is
// (R, N), shared by the P points; 1 = (P*R, N), one row of rates per row.
// threads: the CTA's threads, a multiple of 32 up to 1024 for float and 512
// for double.
#define ATORCH_EVOLVE(NAME, T)                                                \
  extern "C" int NAME(const void* v0, const void* s0, const void* init_ind,   \
                      const void* beta, void* last_ind, void* last_time,      \
                      void* crossed_ind, void* crossed_time, void* accept,    \
                      void* n_events, void* sched, void* times,               \
                      void* row_scratch, void* fallbacks, int P, int R,       \
                      int N, int M, int E,                                    \
                      int W, int pad_b, int beta_per_row, int threads,        \
                      int counter_max,                                        \
                      double vth, double drive, double gap,                   \
                      double a1, double a2, double b1, double b2, double dx,  \
                      double t_horizon, double root_tol, void* stream) {      \
    const Consts c{vth, drive, gap, a1, a2, -b1, -b2, dx, t_horizon,          \
                   root_tol, counter_max};                                    \
    return launch<T>(v0, s0, init_ind, beta, last_ind, last_time,             \
                     crossed_ind, crossed_time, accept, n_events, sched,      \
                     times, row_scratch, fallbacks, P, R, N, M, E, W, pad_b,  \
                     beta_per_row, threads, c, stream);                       \
  }

ATORCH_EVOLVE(atorch_evolve_f32, float)
ATORCH_EVOLVE(atorch_evolve_f64, double)

extern "C" const char* atorch_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
