// df_step, df_step_grid, df_step_c1 and df_step_profile: the df32 tier,
// op12 RK4 in double-word float32 (value = hi + lo), one step loop
// (df.cuh::run_df) instantiated on five media.
//
// Replaces raytracing_tpu/kernels/df.py::_df_rk4_kernel in both its forms,
// launched at df.py:275 (_df_core: the launch state in, four position
// planes out) and df.py:314 (_df_core_segmented: the full 8-plane state in
// and out), as one kernel that always reads and writes the 8-plane state
// (xh, xl, yh, yl, uxh, uxl, uyh, uyl): a chain of launches equals one
// launch to the bit.  The same loop also runs the JAX package's jnp-level
// tracer of the split-word sampled media, engine/df_grid.py::
// _df_grid_segment (df_grid.py:394), on its three evaluators:
// * df_step: the analytic fisheye and vert_heterogeneous angle rates
//   (df.py:199-232), rows 9 and 10 of the kernel table in PERF.md;
// * df_step_grid: DfGridMedium, bilinear n from the Z nodes and bicubic
//   cx/cy cells (df_grid.py:183 _make_df_nag), row 9g;
// * df_step_c1: DfC1Medium, three tensor Horners of one spline
//   (df_grid.py:299 _make_df_c1_nag), row 9c;
// * df_step_profile: DfC1Profile, two cubic Horners of a 1-D spline
//   (df_grid.py:361 _make_df_profile_nag), row 9p;
// the table media share the rate (u x grad n)/n of _make_df_k (:376-391).
// The step, its primitives and the media are __host__ __device__ in
// df.cuh; this file holds the kernel and its C entry points.
//
// One thread per ray; the eight state planes live in registers for every
// step and are read and written once a launch (64 bytes a ray).  A step is
// ~800 FP32 operations on the analytic fields and ~4,000-6,000 on the
// tables as the plain version counts them (four angle-rate evaluations,
// each a few dozen exact products), against one table row an evaluation
// (64-384 bytes, read through L1/L2), so the kernel is bound by FP32
// issue.  What it does about that: each exact product is one FMUL and one
// FFMA (df.cuh two_prod) where the plain version's Dekker split takes 17
// operations, with the same bits; nothing else is fused.  The TPU's Mosaic
// compile bound that made JAX chain 512-step segments does not apply:
// segments here serve resume only.  The tables are read as each ray's own
// cell row of the whole table, hi and lo words interleaved a coefficient
// (engine/df_grid.py kernel_tables), in 16-byte loads.
//
// Built with -fmad=false (kernels/build.py) like every kernel here: the
// error-free transformations are exact only if no other product is fused
// into an add (df.cuh has the rest of what bit parity needs).
#include "common.cuh"
#include "df.cuh"

namespace rt {
namespace df {

struct DfArgs {
  const float* in[8];
  float* out[8];
  int n, steps;
  float ds;
};

template <class Medium>
__global__ void __launch_bounds__(kThreads) df_kernel(DfArgs a, Medium m) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.n) return;
  float s[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = a.in[j][r];
  run_df(m, a.ds, a.steps, s);
#pragma unroll
  for (int j = 0; j < 8; ++j) a.out[j][r] = s[j];
}

template <class Medium>
static int launch(const DfArgs& a, const Medium& m, cudaStream_t stream) {
  const int blocks = (a.n + kThreads - 1) / kThreads;
  df_kernel<Medium><<<blocks, kThreads, 0, stream>>>(a, m);
  return static_cast<int>(cudaGetLastError());
}

static DfArgs args(void* const* in, void* const* out, int n, int steps,
                   float ds) {
  DfArgs a;
  for (int j = 0; j < 8; ++j) {
    a.in[j] = static_cast<const float*>(in[j]);
    a.out[j] = static_cast<float*>(out[j]);
  }
  a.n = n;
  a.steps = steps;
  a.ds = ds;
  return a;
}

}  // namespace df
}  // namespace rt

#define RT_DF_PARAMS \
  void *const *in, void *const *out, int n, int steps, float ds
#define RT_DF_GEOMETRY                                                      \
  float x0h, float x0l, float y0h, float y0l, float ihxh, float ihxl,       \
      float ihyh, float ihyl, int nx, int ny

// df_step: field 0 = fisheye, 1 = vert_heterogeneous (kernels/df.py
// DF_FIELDS); rows 9 and 10
extern "C" int rt_df_step(int field, RT_DF_PARAMS, void* stream) {
  if (n <= 0) return 0;
  const rt::df::DfArgs a = rt::df::args(in, out, n, steps, ds);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (field) {
    case 0:
      return rt::df::launch(a, rt::df::DfAnalytic<rt::df::DF_FISHEYE>{}, s);
    case 1:
      return rt::df::launch(a, rt::df::DfAnalytic<rt::df::DF_VERT>{}, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// df_step_grid: DfGridMedium's packed node and cell tables; row 9g
extern "C" int rt_df_step_grid(RT_DF_PARAMS, const void* nodes,
                               const void* cells, RT_DF_GEOMETRY,
                               void* stream) {
  if (n <= 0) return 0;
  const rt::df::DfGrid m{static_cast<const float*>(nodes),
                         static_cast<const float*>(cells),
                         x0h, x0l, y0h, y0l, ihxh, ihxl, ihyh, ihyl, nx, ny};
  return rt::df::launch(rt::df::args(in, out, n, steps, ds), m,
                        static_cast<cudaStream_t>(stream));
}

// df_step_c1: DfC1Medium's packed cell table; row 9c
extern "C" int rt_df_step_c1(RT_DF_PARAMS, const void* cells, RT_DF_GEOMETRY,
                             void* stream) {
  if (n <= 0) return 0;
  const rt::df::DfC1 m{static_cast<const float*>(cells), x0h, x0l, y0h, y0l,
                       ihxh, ihxl, ihyh, ihyl, nx, ny};
  return rt::df::launch(rt::df::args(in, out, n, steps, ds), m,
                        static_cast<cudaStream_t>(stream));
}

// df_step_profile: DfC1Profile's packed cell table; row 9p
extern "C" int rt_df_step_profile(RT_DF_PARAMS, const void* cells, float y0h,
                                  float y0l, float ihyh, float ihyl, int ny,
                                  void* stream) {
  if (n <= 0) return 0;
  const rt::df::DfProfile m{static_cast<const float*>(cells), y0h, y0l, ihyh,
                            ihyl, ny};
  return rt::df::launch(rt::df::args(in, out, n, steps, ds), m,
                        static_cast<cudaStream_t>(stream));
}
