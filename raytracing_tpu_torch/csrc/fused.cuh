// The fused integrator's step loop for op1/2/3/4/6/7/8/12, templated on the
// medium (media.cuh, or a generated custom medium) and the op: its
// arguments, the per-ray step functions, the two kernels that schedule them,
// their launchers and the C parameter list of every fused entry point.
// fused.cu instantiates it on the analytic, stratified, grid and node-table
// media; kernels/custom.py generates one translation unit a (custom medium,
// op) that includes this header and instantiates the one loop it needs.
// What the loop computes, and what bounds it, is described at the top of
// fused.cu.
//
// One ray's work is __host__ __device__ functions on its carry (Ray):
// load_ray, budget (the steps before the step limit), step (one step) and
// store_ray; run_ray is the whole loop of one ray.  They also build for the
// host with g++ (the CUDA qualifiers stubbed, -ffp-contract=off), where the
// CPU tests hold them to the plain version (kernels/fused.py::
// fused_step_plain) to the bit.
//
// Two kernels schedule them:
// * fused_kernel: one ray a thread, run_ray; the analytic fisheye and vert
//   fields, the grid, node-table and custom media and the sweep (Refills
//   below says why).
// * fused_kernel_refill: a persistent grid for the analytic interface and
//   the stratified media, whose fans (a scenario's launch angles resized to
//   2^20 rays) put rays of very different lifetimes in one warp.  A thread takes rays until
//   none is left: the loop is flat, one step of whatever ray each lane
//   holds, and a lane whose ray froze stores it and takes the next at once,
//   so it does not idle until the warp's longest ray ends.  Lanes that need
//   a ray vote; they take the warp's reserve of rays first, and when that
//   runs out one leader takes at least kRefillChunk more indices from a
//   counter in global memory (one atomicAdd a warp, never one a lane), each
//   lane base + its rank among the voters (refill_more, refill_next: the
//   host build runs them too).  While every lane's ray is live
//   the warp steps without that bookkeeping (a vote a step), until any ray
//   freezes.  The first ray of every thread is its global index, without the
//   counter.  Each lane carries its own ray's step count and step budget
//   (budget: the steps before its limit), so a ray taken late runs exactly
//   the steps, with the same global step numbers, that it runs alone.
//   The reserve, the vote's arithmetic and the persistent grid are in
//   refill.cuh, which the golden loop's refill shares.
#pragma once

#include "refill.cuh"

namespace rt {

struct FusedArgs {
  Planes in, out;
  int n, steps, stats;
  float ds, limit, offset, curv_tol;
  float box[4];
  // per-ray step size and step limit (fused_sweep_grid), or null
  const float* ds_ray;
  const float* limit_ray;
  // the refill kernel's ray counter (one int, 0 at launch), or null
  int* next;
};

// One ray's carry: the state planes, its step size and step limit, and n
// and grad n at (x, y)
struct Ray {
  float x, y, ux, uy, cx, cy, tt, dsim;
  float cnt, mean, m2;          // the Welford tracker (stats)
  float wax, way, wbx, wby;     // op7's window: p_{-2}, p_{-1}
  float ds, limit;
  float n, gx, gy;
  float rny;   // 1 / n where n is in recip_pos's range (Quick steps)
  bool active;
};

// The steps that divide several numerators by n and n2 (op2: k1, k2;
// op6: the position's ds^2 / 2n too): they take the fast path
// (advance<..., true>: quotients from the carried reciprocal of n, the
// analytic fields' reciprocal, the step length's square root, each
// correctly rounded where its guard holds, with no branch) and test the
// guards once; where any fails, they take the step again with the IEEE
// operations (advance<..., false>, the plain version's operations one by
// one), from the same carry.  Either way the same bits.  Not on the
// analytic interface, whose literal logistic gives a gradient below 2^-100
// (or subnormal) over a band of y on either side of its width, where the
// guard fails and the step would run twice (PERF.md, section 6): there
// every step takes the IEEE operations, as before.  op1 keeps its IEEE
// step everywhere: its one guarded operation, the impulse's rsqrtf, costs
// less than a guard, its test and the rerun would (PERF.md section 5).
template <class Medium, int OP>
struct Quick {
  static constexpr bool value = OP == 2 || OP == 6;
};
template <int FIELD, int OP>
struct Quick<Analytic<FIELD>, OP> {
  static constexpr bool value = (OP == 2 || OP == 6) && FIELD != INTERFACE;
};

// medium.nag_fast where the medium has one (the analytic fields), its
// guards ANDed into ok; else medium.nag
template <class Medium>
RT_HD auto nag_q(const Medium& m, float x, float y, float& n, float& gx,
                 float& gy, bool& ok, int)
    -> decltype(m.nag_fast(x, y, n, gx, gy, ok), void()) {
  m.nag_fast(x, y, n, gx, gy, ok);
}
template <class Medium>
RT_HD void nag_q(const Medium& m, float x, float y, float& n, float& gx,
                 float& gy, bool&, long) {
  m.nag(x, y, n, gx, gy);
}

template <class Medium, int OP>
RT_HD void load_ray(const FusedArgs& a, const Medium& medium, int r, Ray& s) {
  s.x = ld(a.in, X, r);
  s.y = ld(a.in, Y, r);
  s.ux = ld(a.in, UX, r);
  s.uy = ld(a.in, UY, r);
  s.cx = ld(a.in, CX, r);
  s.cy = ld(a.in, CY, r);
  s.tt = ld(a.in, TT, r);
  s.dsim = ld(a.in, DSIM, r);
  s.active = static_cast<const bool*>(a.in.p[ACTIVE])[r];
  s.cnt = s.mean = s.m2 = 0.0f;
  if (a.stats) {
    s.cnt = ld(a.in, CNT, r);
    s.mean = ld(a.in, MEAN, r);
    s.m2 = ld(a.in, M2, r);
  }
  s.wax = s.way = s.wbx = s.wby = 0.0f;
  if (OP == 7) {
    s.wax = ld(a.in, WAX, r);
    s.way = ld(a.in, WAY, r);
    s.wbx = ld(a.in, WBX, r);
    s.wby = ld(a.in, WBY, r);
  }
  s.ds = a.ds_ray ? a.ds_ray[r] : a.ds;
  s.limit = a.limit_ray ? a.limit_ray[r] : a.limit;
  medium.nag(s.x, s.y, s.n, s.gx, s.gy);
  if (Quick<Medium, OP>::value) s.rny = recip_pos(s.n).y;
}

// one step of OP (fused.py:430-608) from the ray's step i of this launch;
// stats is a.stats (a constant where the caller knows it).  FAST (Quick
// ops only): the fast path, every guard ANDed into ok
template <class Medium, int OP, bool FAST>
RT_HD void advance(const FusedArgs& a, const Medium& medium, Ray& s, int i,
                   bool stats, bool& ok) {
  constexpr bool kSecond = OP == 6 || OP == 7 || OP == 8;
  constexpr bool kCurv = OP == 3 || OP == 4;
  constexpr bool kRk2 = OP == 2 || OP == 3 || OP == 6;
  constexpr bool kWindow = OP == 7;
  constexpr bool kRk4 = OP == 12;
  const float ds = s.ds;
  const float x = s.x, y = s.y, ux = s.ux, uy = s.uy;
  const float n = s.n, gx = s.gx, gy = s.gy;
  // the carried reciprocal of n, its guard tested where it is used
  const Recip rn{n, s.rny, pos_range(n)};

  // -- position advance ------------------------------------------------
  float ddx, ddy;
  bool significant = true;
  float rk4_ux = 0.0f, rk4_uy = 0.0f;
  if (kRk4) {
    // joint RK4 (ops/registry.py op12), intermediate tangents by rotation
    const float h = ds;
    const float k1t = (ux * gy - uy * gx) / n;
    float u1x, u1y, u2x, u2y, u3x, u3y, nb, gbx, gby, nc, gcx, gcy, nd, gdx,
        gdy;
    rot(ux, uy, 0.5f * h * k1t, u1x, u1y);
    medium.nag(x + 0.5f * h * ux, y + 0.5f * h * uy, nb, gbx, gby);
    const float k2t = (u1x * gby - u1y * gbx) / nb;
    rot(ux, uy, 0.5f * h * k2t, u2x, u2y);
    medium.nag(x + 0.5f * h * u1x, y + 0.5f * h * u1y, nc, gcx, gcy);
    const float k3t = (u2x * gcy - u2y * gcx) / nc;
    rot(ux, uy, h * k3t, u3x, u3y);
    medium.nag(x + h * u2x, y + h * u2y, nd, gdx, gdy);
    const float k4t = (u3x * gdy - u3y * gdx) / nd;
    const float h6 = h / 6.0f;
    ddx = h6 * (ux + 2.0f * u1x + 2.0f * u2x + u3x);
    ddy = h6 * (uy + 2.0f * u1y + 2.0f * u2y + u3y);
    const float dth = h6 * (k1t + 2.0f * k2t + 2.0f * k3t + k4t);
    rot(ux, uy, dth, rk4_ux, rk4_uy);
  } else if (kSecond) {
    // r += u ds + (grad - (grad.u) u) ds^2 / 2n
    const float gdotu = gx * ux + gy * uy;
    const float num = ds * ds * 0.5f;
    const float half_fac = FAST ? div_fast_pos(num, rn, ok) : num / n;
    ddx = ux * ds + (gx - gdotu * ux) * half_fac;
    ddy = uy * ds + (gy - gdotu * uy) * half_fac;
  } else if (kCurv) {
    const float gdotu = gx * ux + gy * uy;
    significant = arc_advance(ux, uy, gx, gy, gx - gdotu * ux,
                              gy - gdotu * uy, n, ds, a.curv_tol, ddx, ddy);
  } else {
    ddx = ux * ds;
    ddy = uy * ds;
  }
  float nx2, ny2, cx2, cy2;
  kahan(x, s.cx, ddx, nx2, cx2);
  kahan(y, s.cy, ddy, ny2, cy2);

  float n2, gx2, gy2;
  if (FAST) {
    nag_q(medium, nx2, ny2, n2, gx2, gy2, ok, 0);
  } else {
    medium.nag(nx2, ny2, n2, gx2, gy2);
  }
  // the next step's reciprocal of n (its y read only where its ok holds)
  Recip rn2{};
  if (Quick<Medium, OP>::value) rn2 = recip_pos(n2);

  // -- angle update ----------------------------------------------------
  float nux, nuy;
  if (kRk4) {
    nux = rk4_ux;
    nuy = rk4_uy;
  } else if (kWindow) {
    // MxSA backward difference with the order ramp on the global step
    const float step_f = (float)i + a.offset + 1.0f;
    const bool is1 = step_f == 1.0f, is2 = step_f == 2.0f;
    const float ca = is1 ? 0.0f : (is2 ? 0.0f : -2.0f);
    const float cb = is1 ? 0.0f : (is2 ? 1.0f : 9.0f);
    const float cc = is1 ? -1.0f : (is2 ? -4.0f : -18.0f);
    const float cd = is1 ? 1.0f : (is2 ? 3.0f : 11.0f);
    const float vx = ca * s.wax + cb * s.wbx + cc * x + cd * nx2;
    const float vy = ca * s.way + cb * s.wby + cc * y + cd * ny2;
    const float inv = rsqrt_f(vx * vx + vy * vy);
    nux = vx * inv;
    nuy = vy * inv;
  } else if (kRk2) {
    // tfinal_2o: rotate the tangent by the k1/k2 increments
    const float num1 = ds * (ux * gy - uy * gx);
    const float k1 = FAST ? div_fast_pos(num1, rn, ok) : num1 / n;
    float ux1, uy1;
    rot(ux, uy, k1, ux1, uy1);
    const float num2 = ds * (ux1 * gy2 - uy1 * gx2);
    const float k2 = FAST ? div_fast_pos(num2, rn2, ok) : num2 / n2;
    rot(ux, uy, (k1 + k2) * 0.5f, nux, nuy);
  } else {
    // theta_cost_t: normalized momentum + trapezoid impulse
    const float half = ds * 0.5f;
    const float sx = n * ux + (gx + gx2) * half;
    const float sy = n * uy + (gy + gy2) * half;
    const float inv = rsqrt_f(sx * sx + sy * sy);
    nux = sx * inv;
    nuy = sy * inv;
  }
  if (kCurv && !significant) {
    // negligible curvature keeps the old angle (RT_bench.py:538-541)
    nux = ux;
    nuy = uy;
  }

  if (kSecond || kCurv || kRk4) {
    const float d2 = ddx * ddx + ddy * ddy;
    const float dist = FAST ? sqrt_fast(d2, ok) : sqrtf(d2);
    s.tt = s.tt + dist * (n + n2) * 0.5f;
    s.dsim = s.dsim + dist;
  } else {
    s.tt = s.tt + ds * (n + n2) * 0.5f;
    s.dsim = s.dsim + ds;
  }
  if (stats) {
    // Welford over the post-step m_x = n2 * nux (engine/trace.py body)
    const float mx2 = n2 * nux;
    s.cnt = s.cnt + 1.0f;
    const float delta = mx2 - s.mean;
    s.mean = s.mean + delta / s.cnt;
    s.m2 = s.m2 + delta * (mx2 - s.mean);
  }
  if (kWindow) {
    s.wax = s.wbx;
    s.way = s.wby;
    s.wbx = x;
    s.wby = y;
  }
  s.x = nx2;
  s.y = ny2;
  s.cx = cx2;
  s.cy = cy2;
  s.ux = nux;
  s.uy = nuy;
  s.n = n2;
  s.gx = gx2;
  s.gy = gy2;
  s.rny = rn2.y;
}

// one step of OP from the ray's step i of this launch (advance); a Quick
// op's takes the fast path and, where a guard fails, the step again with
// the IEEE operations from the same carry
template <class Medium, int OP>
RT_HD void step(const FusedArgs& a, const Medium& medium, Ray& s, int i,
                bool stats) {
  bool ok = true;
  if constexpr (Quick<Medium, OP>::value) {
    Ray t = s;
    advance<Medium, OP, true>(a, medium, t, i, stats, ok);
    if (!ok) {
      t = s;
      advance<Medium, OP, false>(a, medium, t, i, stats, ok);
    }
    s = t;
  } else {
    advance<Medium, OP, false>(a, medium, s, i, stats, ok);
  }
  // strict box exit (RT_bench.py:878): the exiting step is kept
  if (outside(s.x, s.y, a.box)) s.active = false;
}

template <int OP>
RT_HD void store_ray(const FusedArgs& a, int r, const Ray& s) {
  st(a.out, X, r, s.x);
  st(a.out, Y, r, s.y);
  st(a.out, UX, r, s.ux);
  st(a.out, UY, r, s.uy);
  st(a.out, CX, r, s.cx);
  st(a.out, CY, r, s.cy);
  st(a.out, TT, r, s.tt);
  st(a.out, DSIM, r, s.dsim);
  static_cast<bool*>(a.out.p[ACTIVE])[r] = s.active;
  if (a.stats) {
    st(a.out, CNT, r, s.cnt);
    st(a.out, MEAN, r, s.mean);
    st(a.out, M2, r, s.m2);
  }
  if (OP == 7) {
    st(a.out, WAX, r, s.wax);
    st(a.out, WAY, r, s.way);
    st(a.out, WBX, r, s.wbx);
    st(a.out, WBY, r, s.wby);
  }
}

// A frozen ray never changes again (fused.py:585-592): it left the box, or
// its global step i + offset reached its step limit.  budget is the steps
// ray s may take in this launch before that limit (common.cuh step_budget)
RT_HD int budget(const FusedArgs& a, const Ray& s) {
  return step_budget(a.steps, a.offset, s.limit);
}

// the ray's steps 0 .. stop - 1 of this launch, until it leaves the box.
// A Quick op's loop runs two steps an iteration, the box tested after
// each, then the odd one (one loop test for two steps); the others keep
// one step an iteration, where two gave the grid's op1 more carry moves
// than loop tests saved (PERF.md section 5)
template <class Medium, int OP, bool STATS>
RT_HD void run_steps(const FusedArgs& a, const Medium& medium, Ray& s,
                     int stop) {
  int i = 0;
  if constexpr (Quick<Medium, OP>::value) {
    if (!s.active) return;
    for (; i + 1 < stop; i += 2) {
      step<Medium, OP>(a, medium, s, i, STATS);
      if (!s.active) return;
      step<Medium, OP>(a, medium, s, i + 1, STATS);
      if (!s.active) return;
    }
  }
  for (; i < stop && s.active; ++i) step<Medium, OP>(a, medium, s, i, STATS);
}

// ray r's a.steps steps: a thread leaves the loop as soon as the ray is
// frozen, since its state never changes again.  The stats flag picks the
// loop once, so that a launch without them computes no Welford update (it
// has no side effect, so with a run-time flag the compiler computed it
// every step and kept it unstored)
template <class Medium, int OP>
RT_HD void run_ray(const FusedArgs& a, const Medium& medium, int r) {
  Ray s;
  load_ray<Medium, OP>(a, medium, r, s);
  const int stop = budget(a, s);
  if (a.stats) {
    run_steps<Medium, OP, true>(a, medium, s, stop);
  } else {
    run_steps<Medium, OP, false>(a, medium, s, stop);
  }
  store_ray<OP>(a, r, s);
}

static FusedArgs fused_args(int stats, void* const* in, void* const* out,
                            int n, int steps, float ds, float limit,
                            float offset, float limx_i, float limx_s,
                            float limy_i, float limy_s, float curv_tol) {
  FusedArgs a;
  for (int k = 0; k < NSLOTS; ++k) {
    a.in.p[k] = in[k];
    a.out.p[k] = out[k];
  }
  a.n = n;
  a.steps = steps;
  a.stats = stats;
  a.ds = ds;
  a.limit = limit;
  a.offset = offset;
  a.curv_tol = curv_tol;
  a.box[0] = limx_i;
  a.box[1] = limx_s;
  a.box[2] = limy_i;
  a.box[3] = limy_s;
  a.ds_ray = nullptr;
  a.limit_ray = nullptr;
  a.next = nullptr;
  return a;
}

#ifdef __CUDACC__

template <class Medium, int OP>
__global__ void __launch_bounds__(kThreads)
    fused_kernel(FusedArgs a, Medium medium) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.n) return;
  run_ray<Medium, OP>(a, medium, r);
}

// The candidate sweep (fused_sweep_grid): the grid loop (run_ray) with
// each candidate on a warp of its own, in blocks of one warp (candidate r
// on block r's first lane), so that the candidates spread over every SM
// and no lane waits on another's steps or table reads.  A launch is one
// candidate's serial chain of steps, so latency, not issue, bounds it
// (fused.cu has the measurements).
constexpr int kSweepThreads = 32;

template <int CELL_CH, int OP>
__global__ void __launch_bounds__(kSweepThreads)
    sweep_kernel(FusedArgs a, Grid<CELL_CH> medium) {
  if (threadIdx.x != 0 || static_cast<int>(blockIdx.x) >= a.n) return;
  run_ray<Grid<CELL_CH>, OP>(a, medium, blockIdx.x);
}

// The persistent refill loop (top of this file), one kernel a stats flag,
// so that each has its own register count (the Welford tracker's three
// floats do not lower the occupancy of a launch without it).  Every lane of
// a 128-thread block enters the loop, so the first vote's mask is the full
// warp; a lane leaves only when the counter has no ray left for it, and the
// mask follows.
template <class Medium, int OP, bool STATS>
__global__ void __launch_bounds__(kThreads)
    fused_kernel_refill(FusedArgs a, Medium medium) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  // rays [0, taken) are each thread's first, by its global index
  const long long taken = (long long)gridDim.x * blockDim.x;
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  bool has = r < a.n;
  int i = 0, stop = 0;
  Ray s;
  if (has) {
    load_ray<Medium, OP>(a, medium, r, s);
    stop = budget(a, s);
  }
  unsigned warp = 0xffffffffu;
  Reserve w{0, 0};
  for (;;) {
    // live: the ray is neither at its step budget nor out of the box
    bool live = has && i < stop && s.active;
    if (has && !live) {
      store_ray<OP>(a, r, s);
      has = false;
    }
    const unsigned need = __ballot_sync(warp, !has);
    if (need != 0u) {
      // the lanes that need a ray take the reserve first, in rank order;
      // where it runs out, one leader takes what it lacks, or a chunk
      const int k = __popc(need), rank = __popc(need & below);
      const int more = refill_more(w, k, kRefillChunk);
      int base = 0;
      if (more != 0) {
        const int leader = __ffs(need) - 1;
        if (lane == leader) base = atomicAdd(a.next, more);
        base = __shfl_sync(warp, base, leader);
      }
      const long long next = refill_next(w, k, rank, more, taken, base);
      if (!has && next < a.n) {
        r = static_cast<int>(next);
        has = true;
        i = 0;
        load_ray<Medium, OP>(a, medium, r, s);
        stop = budget(a, s);
        live = 0 < stop && s.active;
      }
      warp = __ballot_sync(warp, has);
      if (!has) return;
    }
    // one step of each live ray; while every lane's ray is live, go on
    // stepping without the refill's bookkeeping, until a ray freezes
    const bool all = __all_sync(warp, live);
    if (live) {
      do {
        step<Medium, OP>(a, medium, s, i, STATS);
        ++i;
      } while (all && __all_sync(warp, i < stop && s.active));
    }
  }
}

// The media whose launches take the refill loop: the analytic interface
// and the 1-D tables, whose rays reflect at or cross the interface and
// leave the box at very different steps (the interface fan's warps spend
// 56 % of their lane-steps on frozen rays one ray a thread).  The other
// analytic fields keep one ray a thread: the fisheye's fan is one ray
// repeated, where the refill adds its vote a step and wins nothing, and
// the main path's vert runs are 76-step launches, too short to win back
// the refill's cost a ray.
template <class Medium>
struct Refills {
  static constexpr bool value = false;
};
template <int FIELD>
struct Refills<Analytic<FIELD>> {
  static constexpr bool value = FIELD == INTERFACE;
};
template <int CH>
struct Refills<Strat<CH>> {
  static constexpr bool value = true;
};

// the refill kernel's grid for n rays on the current device: as many
// blocks as every SM holds at once (the occupancy of this instantiation,
// read once a device), never more than the rays fill
template <class Medium, int OP, bool STATS>
static int refill_blocks(int n, int* blocks) {
  static int per_sm[kMaxDevices];
  return persistent_grid(fused_kernel_refill<Medium, OP, STATS>, per_sm, n,
                         blocks);
}

// one instantiation: the loop of OP on Medium (a generated custom-medium
// library instantiates only the op it was built for)
template <class Medium, int OP>
static int launch_fused_op(const FusedArgs& a, const Medium& m,
                           cudaStream_t s) {
  if constexpr (Refills<Medium>::value) {
    if (a.next == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    // the ray counter starts each launch at 0, on the launch's stream
    const cudaError_t e = cudaMemsetAsync(a.next, 0, sizeof(int), s);
    if (e != cudaSuccess) return static_cast<int>(e);
    int blocks = 0;
    if (a.stats) {
      const int err = refill_blocks<Medium, OP, true>(a.n, &blocks);
      if (err != 0) return err;
      fused_kernel_refill<Medium, OP, true><<<blocks, kThreads, 0, s>>>(a, m);
    } else {
      const int err = refill_blocks<Medium, OP, false>(a.n, &blocks);
      if (err != 0) return err;
      fused_kernel_refill<Medium, OP, false><<<blocks, kThreads, 0, s>>>(a,
                                                                        m);
    }
  } else {
    const int blocks = (a.n + kThreads - 1) / kThreads;
    fused_kernel<Medium, OP><<<blocks, kThreads, 0, s>>>(a, m);
  }
  return static_cast<int>(cudaGetLastError());
}

// every op of the family on Medium, chosen at run time
template <class Medium>
static int launch_fused(int op, const FusedArgs& a, const Medium& m,
                        cudaStream_t s) {
  switch (op) {
    case 1: return launch_fused_op<Medium, 1>(a, m, s);
    case 2: return launch_fused_op<Medium, 2>(a, m, s);
    case 3: return launch_fused_op<Medium, 3>(a, m, s);
    case 4: return launch_fused_op<Medium, 4>(a, m, s);
    case 6: return launch_fused_op<Medium, 6>(a, m, s);
    case 7: return launch_fused_op<Medium, 7>(a, m, s);
    case 8: return launch_fused_op<Medium, 8>(a, m, s);
    case 12: return launch_fused_op<Medium, 12>(a, m, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// one op of the sweep, a block a candidate: the kernel prefers L1 to
// shared memory, which it does not use, so that an SM's L1 holds the rows
// of its candidates' cells
template <int CELL_CH, int OP>
static int launch_sweep_op(const FusedArgs& a, const Grid<CELL_CH>& m,
                           cudaStream_t s) {
  static bool carved[kMaxDevices];
  int dev = 0;
  int err = current_device(&dev);
  if (err != 0) return err;
  if (!carved[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        sweep_kernel<CELL_CH, OP>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxL1);
    if (e != cudaSuccess) return static_cast<int>(e);
    carved[dev] = true;
  }
  sweep_kernel<CELL_CH, OP><<<a.n, kSweepThreads, 0, s>>>(a, m);
  return static_cast<int>(cudaGetLastError());
}

// every op of the family on the grid, chosen at run time
template <int CELL_CH>
static int launch_sweep(int op, const FusedArgs& a, const Grid<CELL_CH>& m,
                        cudaStream_t s) {
  switch (op) {
    case 1: return launch_sweep_op<CELL_CH, 1>(a, m, s);
    case 2: return launch_sweep_op<CELL_CH, 2>(a, m, s);
    case 3: return launch_sweep_op<CELL_CH, 3>(a, m, s);
    case 4: return launch_sweep_op<CELL_CH, 4>(a, m, s);
    case 6: return launch_sweep_op<CELL_CH, 6>(a, m, s);
    case 7: return launch_sweep_op<CELL_CH, 7>(a, m, s);
    case 8: return launch_sweep_op<CELL_CH, 8>(a, m, s);
    case 12: return launch_sweep_op<CELL_CH, 12>(a, m, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the refill grid launch_fused would give op on Medium for n rays
template <class Medium, bool STATS>
static int refill_blocks_of(int op, int n, int* blocks) {
  switch (op) {
    case 1: return refill_blocks<Medium, 1, STATS>(n, blocks);
    case 2: return refill_blocks<Medium, 2, STATS>(n, blocks);
    case 3: return refill_blocks<Medium, 3, STATS>(n, blocks);
    case 4: return refill_blocks<Medium, 4, STATS>(n, blocks);
    case 6: return refill_blocks<Medium, 6, STATS>(n, blocks);
    case 7: return refill_blocks<Medium, 7, STATS>(n, blocks);
    case 8: return refill_blocks<Medium, 8, STATS>(n, blocks);
    case 12: return refill_blocks<Medium, 12, STATS>(n, blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
// (0 where Medium runs one ray a thread)
template <class Medium>
static int refill_blocks_of(int op, int stats, int n, int* blocks) {
  if constexpr (Refills<Medium>::value) {
    return stats ? refill_blocks_of<Medium, true>(op, n, blocks)
                 : refill_blocks_of<Medium, false>(op, n, blocks);
  } else {
    *blocks = 0;
    return 0;
  }
}

#endif  // __CUDACC__

}  // namespace rt

#define RT_FUSED_PARAMS                                                     \
  int op, int stats, void *const *in, void *const *out, int n, int steps,   \
      float ds, float limit, float offset, float limx_i, float limx_s,      \
      float limy_i, float limy_s, float curv_tol
#define RT_FUSED_ARGS                                                        \
  rt::fused_args(stats, in, out, n, steps, ds, limit, offset, limx_i, limx_s, \
                 limy_i, limy_s, curv_tol)
