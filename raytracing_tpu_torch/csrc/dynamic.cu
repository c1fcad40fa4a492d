// dynamic_step, dynamic_step_strat and dynamic_step_grid: the dynamic
// integrator (kinematics plus the paraxial tangent d(state)/d(theta0), the
// KMAH caustic count, Kahan carries) for op1/op2/op6/op8, one step loop
// instantiated on three media (media.cuh nag_h).
//
// Replaces raytracing_tpu/kernels/dynamic.py::_make_dynamic_kernel
// (dynamic.py:347-586):
// * dynamic_step: the analytic fields of _field_fn_h, launched at
//   dynamic.py:646 (dynamic_trace_final), rt_dynamic_step (row 11 of the
//   kernel table in PERF.md);
// * dynamic_step_strat: the stratified tables of _strat_nag_h, launched at
//   dynamic.py:722 (dynamic_trace_final_strat), rt_dynamic_step_strat
//   (row 12);
// * dynamic_step_grid: the 2-D per-cell tables of _tile_nag_h /
//   _tile_nag_c1_h, launched in resume form at engine/segmented.py:1702
//   (grid_trace_dynamic_tiled), rt_dynamic_step_grid (row 8).
//
// All three read and write the 18 state planes of JAX's resume layout
// (segmented.py:1844-1850: x, y, cx, cy, ux, uy, tt, dsim, active, dpx, dpy,
// dth, sgn, kmah, kdx, kdy, kdt, ktt) with a global step offset, so k steps
// then n - k equal n steps; the JAX analytic and stratified kernels take
// (pos0, theta0) instead, which is the launch state dth = 1, active = 1,
// everything else 0.  The TPU's tiled grid window, Morton sort and replay
// ladder are not ported: every ray reads its own cell's row of the whole
// table (media.cuh Grid), so one launch serves any grid.
//
// The state and the nine field channels stay in registers across every
// step; the field is evaluated once a step, after the move, and carried.
// A step is ~190-370 FP32 operations against 140 bytes of state a ray for
// the whole launch (plus a 32-144-byte table row a step on the sampled
// media, served by L1/L2), so the kernel is bound by FP32 issue.  The
// analytic fields and the grids run one ray a thread (dynamic_kernel),
// which leaves its loop once its ray is frozen (box exit or the step
// limit): a frozen ray's state never changes again.  The stratified
// tables run the persistent refill loop (dynamic_kernel_refill, on
// refill.cuh, as fused.cuh's fused_kernel_refill): their vert_strat fan
// puts rays of very different lifetimes in one warp (one ray a thread, a
// warp spends 0.662 of its lane-steps on live rays), and a lane whose ray
// froze stores it and takes the next ray from the warp's reserve or,
// through one leader's atomicAdd, from a ray counter on the card, which
// rt_dynamic_step_strat takes and zeroes on the launch's stream.  Each
// lane keeps its own ray's step count, so a ray taken late runs the same
// steps, with the same global step numbers, as it runs alone.
//
// The step loop, its carry and the state planes are in dynamic.cuh, whose
// __host__ __device__ functions the CPU tests also build with g++.
#include "dynamic.cuh"

namespace rt {

template <class Medium, int OP>
__global__ void __launch_bounds__(kThreads)
    dynamic_kernel(DynArgs a, Medium medium) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.n) return;
  Dyn s = load_dyn(a, r);
  run_dyn<Medium, OP>(a, medium, s);
  store_dyn(a, r, s);
}

// The persistent refill loop: a lane whose ray froze stores it and votes;
// the voters take the warp's reserve first and, where it runs out, one
// leader takes at least kRefillChunk more indices from the counter
// `next_ray` (refill_more, refill_next); while every lane's ray is live the
// warp steps with one vote a step, two steps an iteration so that the
// carry (f <- f2, 1 / n) renames registers instead of moving them.  Every
// lane of a 128-thread block enters the loop, so the first vote's mask is
// the full warp; a lane leaves only when the counter has no ray left for
// it, and the mask follows.
template <class Medium, int OP>
__global__ void __launch_bounds__(kThreads)
    dynamic_kernel_refill(DynArgs a, Medium medium, int* next_ray) {
  const float ds = a.ds;
  const float dsds_half = ds * ds * 0.5f;
  const float half = ds * 0.5f;
  // the launch's step limit is every ray's: each lane counts its own steps
  const int stop = step_budget(a.steps, a.offset, a.limit);
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  // rays [0, taken) are each thread's first, by its global index
  const long long taken = (long long)gridDim.x * blockDim.x;
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  bool has = r < a.n;
  int i = 0;
  Dyn s;
  float f[9];
  float inv_n = 0.0f;
  if (has) {
    s = load_dyn(a, r);
    dyn_begin<Medium, OP>(medium, s, f, inv_n);
  }
  unsigned warp = 0xffffffffu;
  Reserve w{0, 0};
  for (;;) {
    // live: the ray is neither at its step budget nor out of the box
    bool live = has && i < stop && s.active;
    if (has && !live) {
      store_dyn(a, r, s);
      has = false;
    }
    const unsigned need = __ballot_sync(warp, !has);
    if (need != 0u) {
      const int k = __popc(need), rank = __popc(need & below);
      const int more = refill_more(w, k, kRefillChunk);
      int base = 0;
      if (more != 0) {
        const int leader = __ffs(need) - 1;
        if (lane == leader) base = atomicAdd(next_ray, more);
        base = __shfl_sync(warp, base, leader);
      }
      const long long next = refill_next(w, k, rank, more, taken, base);
      if (!has && next < a.n) {
        r = static_cast<int>(next);
        has = true;
        i = 0;
        s = load_dyn(a, r);
        dyn_begin<Medium, OP>(medium, s, f, inv_n);
        live = 0 < stop && s.active;
      }
      warp = __ballot_sync(warp, has);
      if (!has) return;
    }
    // one step of each live ray; while every lane's ray is live, go on
    // stepping without the refill's bookkeeping, until a ray freezes
    const bool all = __all_sync(warp, live);
    if (live) {
      for (;;) {
        dyn_advance<Medium, OP>(a, medium, s, f, inv_n, ds, dsds_half, half);
        ++i;
        if (!(all && __all_sync(warp, i < stop && s.active))) break;
        dyn_advance<Medium, OP>(a, medium, s, f, inv_n, ds, dsds_half, half);
        ++i;
        if (!(all && __all_sync(warp, i < stop && s.active))) break;
      }
    }
  }
}

// the refill kernel's grid for n rays on the current device (refill.cuh)
template <class Medium, int OP>
static int dynamic_refill_grid(int n, int* blocks) {
  static int per_sm[kMaxDevices];
  return persistent_grid(dynamic_kernel_refill<Medium, OP>, per_sm, n,
                         blocks);
}

template <class Medium, int OP>
static int launch_dynamic_op(const DynArgs& a, const Medium& m, int* next,
                             cudaStream_t s) {
  if constexpr (DynRefills<Medium>::value) {
    if (next == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    // the ray counter starts each launch at 0, on the launch's stream
    const cudaError_t e = cudaMemsetAsync(next, 0, sizeof(int), s);
    if (e != cudaSuccess) return static_cast<int>(e);
    int blocks = 0;
    const int err = dynamic_refill_grid<Medium, OP>(a.n, &blocks);
    if (err != 0) return err;
    dynamic_kernel_refill<Medium, OP><<<blocks, kThreads, 0, s>>>(a, m,
                                                                  next);
  } else {
    const int blocks = (a.n + kThreads - 1) / kThreads;
    dynamic_kernel<Medium, OP><<<blocks, kThreads, 0, s>>>(a, m);
  }
  return static_cast<int>(cudaGetLastError());
}

// op on Medium, chosen at run time; next is the refill loop's counter (one
// int on the card; null where Medium runs one ray a thread)
template <class Medium>
static int launch_dynamic(int op, const DynArgs& a, const Medium& m,
                          int* next, cudaStream_t s) {
  switch (op) {
    case 1: return launch_dynamic_op<Medium, 1>(a, m, next, s);
    case 2: return launch_dynamic_op<Medium, 2>(a, m, next, s);
    case 6: return launch_dynamic_op<Medium, 6>(a, m, next, s);
    case 8: return launch_dynamic_op<Medium, 8>(a, m, next, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

static DynArgs dynamic_args(void* const* in, void* const* out, int n,
                            int steps, float ds, float limit, float offset,
                            float limx_i, float limx_s, float limy_i,
                            float limy_s) {
  DynArgs a;
  for (int k = 0; k < NDSLOTS; ++k) {
    a.in.p[k] = in[k];
    a.out.p[k] = out[k];
  }
  a.n = n;
  a.steps = steps;
  a.ds = ds;
  a.limit = limit;
  a.offset = offset;
  a.box[0] = limx_i;
  a.box[1] = limx_s;
  a.box[2] = limy_i;
  a.box[3] = limy_s;
  return a;
}

}  // namespace rt

#define RT_DYN_PARAMS                                                       \
  int op, void *const *in, void *const *out, int n, int steps, float ds,    \
      float limit, float offset, float limx_i, float limx_s, float limy_i, \
      float limy_s
#define RT_DYN_ARGS                                                       \
  rt::dynamic_args(in, out, n, steps, ds, limit, offset, limx_i, limx_s, \
                   limy_i, limy_s)

// dynamic_step: the analytic fields (row 11 of the kernel table)
extern "C" int rt_dynamic_step(int field, RT_DYN_PARAMS, void* stream) {
  if (n <= 0) return 0;
  const rt::DynArgs a = RT_DYN_ARGS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (field) {
    case rt::FISHEYE:
      return rt::launch_dynamic(op, a, rt::Analytic<rt::FISHEYE>{},
                                  nullptr, s);
    case rt::VERT:
      return rt::launch_dynamic(op, a, rt::Analytic<rt::VERT>{}, nullptr,
                                  s);
    case rt::INTERFACE:
      return rt::launch_dynamic(op, a, rt::Analytic<rt::INTERFACE>{},
                                  nullptr, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dynamic_step_strat: 1-D stratified tables, ch = 6 (parity) or 4 (C1); row
// 12; counter is the refill loop's (one int on the card, which the launch
// zeroes on its stream)
extern "C" int rt_dynamic_step_strat(int ch, RT_DYN_PARAMS, RT_TABLE_PARAMS,
                                     void* counter, void* stream) {
  if (n <= 0) return 0;
  const rt::DynArgs a = RT_DYN_ARGS;
  int* next = static_cast<int*>(counter);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ch) {
    case 6: return rt::launch_dynamic(op, a, rt::Strat<6>{RT_TABLE}, next, s);
    case 4: return rt::launch_dynamic(op, a, rt::Strat<4>{RT_TABLE}, next, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The refill loop's grid for n rays of op on a stratified table (ch 6 or
// 4): blocks of 128 threads, written to *blocks
extern "C" int rt_dynamic_refill_blocks(int ch, int op, int n, int* blocks) {
  if (n <= 0 || blocks == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ch != 6 && ch != 4) return static_cast<int>(cudaErrorInvalidValue);
  const bool parity = ch == 6;
  switch (op) {
    case 1:
      return parity ? rt::dynamic_refill_grid<rt::Strat<6>, 1>(n, blocks)
                    : rt::dynamic_refill_grid<rt::Strat<4>, 1>(n, blocks);
    case 2:
      return parity ? rt::dynamic_refill_grid<rt::Strat<6>, 2>(n, blocks)
                    : rt::dynamic_refill_grid<rt::Strat<4>, 2>(n, blocks);
    case 6:
      return parity ? rt::dynamic_refill_grid<rt::Strat<6>, 6>(n, blocks)
                    : rt::dynamic_refill_grid<rt::Strat<4>, 6>(n, blocks);
    case 8:
      return parity ? rt::dynamic_refill_grid<rt::Strat<6>, 8>(n, blocks)
                    : rt::dynamic_refill_grid<rt::Strat<4>, 8>(n, blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dynamic_step_grid: the 2-D per-cell table, cell_ch = 36 (parity) or 16
// (C1); row 8
extern "C" int rt_dynamic_step_grid(int cell_ch, RT_DYN_PARAMS,
                                    RT_TABLE_PARAMS, void* stream) {
  if (n <= 0) return 0;
  if (!rt::table2_fits(nx, ny))
    return static_cast<int>(cudaErrorInvalidValue);
  const rt::DynArgs a = RT_DYN_ARGS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cell_ch) {
    case 36:
      return rt::launch_dynamic(op, a, rt::Grid<36>{RT_TABLE}, nullptr, s);
    case 16:
      return rt::launch_dynamic(op, a, rt::Grid<16>{RT_TABLE}, nullptr, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
