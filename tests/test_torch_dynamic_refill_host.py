"""The 2-D dynamic loop's refill (raytracing_tpu_torch/csrc/dynamic.cu
``dynamic_kernel_refill``, the persistent loop of ``dynamic_step_strat``)
emulated warp by warp on the host, on csrc/dynamic.cuh and refill.cuh
built with g++ (-ffp-contract=off, the CUDA qualifiers stubbed), against
the plain PyTorch version and the one-ray-a-thread loop ``run_dyn``, all 18
planes to the bit.

The emulation runs warps of 32 lanes over a shared ray counter; each
iteration of a warp mirrors one iteration of the kernel's loop: a lane
whose ray froze (box exit or the step limit) stores it, the lanes that
need a ray vote, take the warp's reserve first and then what one leader's
add on the counter returned (refill.cuh ``refill_more``, ``refill_next``),
each loads its ray and its channels (``load_dyn``, ``dyn_begin``), and the
live lanes step (``dyn_advance``); the warps' iterations are interleaved in
a seeded order.  The cases: the vert_strat fan of the dynamic main path
(a fixed launch point, angles U[0.05, 1.5], ds 0.0193) narrowed to a few
hundred rays and 300 steps, on the parity and C1 stratified tables, op1,
op2, op6 and op8, at 1, 31 and 333 rays, under a short step limit and as a
resume chain of uneven segments; every ray is taken and stored exactly
once; and at the fan's full depth the refill steps fewer lane slots than
one ray a thread does.  PyTorch's CPU ``sqrt`` is not correctly rounded,
so the plain version runs with an IEEE square root and ``rsqrt`` as one
division by it, which is what the header's host build computes.  Skipped
where g++ is missing."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.bench import warp_efficiency  # noqa: E402
from raytracing_tpu_torch.kernels import build  # noqa: E402
from raytracing_tpu_torch.kernels import dynamic as kd  # noqa: E402
from raytracing_tpu_torch.kernels import fused as kfu  # noqa: E402

CPU = dict(device="cpu")

_SRC = r"""#define __host__
#define __device__
#define __forceinline__ inline
#include <vector>
#include "dynamic.cuh"

struct Lane {
  rt::Dyn s;
  float f[9];
  float inv_n = 0.0f;
  int r = 0, i = 0;
  bool has = false, in = true;
};

static int popc(unsigned v) { return __builtin_popcount(v); }

template <class M, int OP>
static void begin(const rt::DynArgs& a, const M& m, Lane& l) {
  l.s = rt::load_dyn(a, l.r);
  rt::dyn_begin<M, OP>(m, l.s, l.f, l.inv_n);
}

// one iteration of one warp of dynamic_kernel_refill's loop
template <class M, int OP>
static bool warp_iteration(const rt::DynArgs& a, int stop, const M& m,
                           Lane* L, rt::Reserve& w, int chunk,
                           long long taken, int& counter, int* stores,
                           long long* tally) {
  const float ds = a.ds, dsds_half = ds * ds * 0.5f, half = ds * 0.5f;
  bool live[32] = {};
  unsigned need = 0, in = 0;
  for (int l = 0; l < 32; ++l) {
    if (!L[l].in) continue;
    in |= 1u << l;
    live[l] = L[l].has && L[l].i < stop && L[l].s.active;
    if (L[l].has && !live[l]) {
      rt::store_dyn(a, L[l].r, L[l].s);
      ++stores[L[l].r];
      L[l].has = false;
    }
    if (!L[l].has) need |= 1u << l;
  }
  if (need != 0u) {
    const int k = popc(need);
    const int more = rt::refill_more(w, k, chunk);
    int base = 0;
    if (more != 0) {
      base = counter;
      counter += more;
    }
    const rt::Reserve before = w;
    for (int l = 0; l < 32; ++l) {
      if (!L[l].in) continue;
      rt::Reserve mine = before;
      const int rank = popc(need & ((1u << l) - 1u));
      const long long next = rt::refill_next(mine, k, rank, more, taken,
                                             base);
      w = mine;
      if (!(need >> l & 1u)) continue;
      if (next < a.n) {
        L[l].r = static_cast<int>(next);
        L[l].has = true;
        L[l].i = 0;
        begin<M, OP>(a, m, L[l]);
        live[l] = 0 < stop && L[l].s.active;
      } else {
        L[l].in = false;
        in &= ~(1u << l);
      }
    }
  }
  if (in == 0u) return false;
  tally[0] += 32;   // lane slots of this iteration
  for (int l = 0; l < 32; ++l) {
    if (L[l].in && live[l]) {
      rt::dyn_advance<M, OP>(a, m, L[l].s, L[l].f, L[l].inv_n, ds,
                             dsds_half, half);
      ++L[l].i;
      ++tally[1];   // steps taken
    }
  }
  return true;
}

template <class M, int OP>
static void run(const rt::DynArgs& a, const M& m, int threads, int chunk,
                unsigned seed, int* stores, long long* tally) {
  if (threads == 0) {
    for (int r = 0; r < a.n; ++r) {
      rt::Dyn s = rt::load_dyn(a, r);
      rt::run_dyn<M, OP>(a, m, s);
      rt::store_dyn(a, r, s);
      ++stores[r];
    }
    return;
  }
  const int stop = rt::step_budget(a.steps, a.offset, a.limit);
  std::vector<Lane> lanes(threads);
  for (int t = 0; t < threads; ++t) {
    lanes[t].r = t;
    lanes[t].has = t < a.n;
    if (lanes[t].has) begin<M, OP>(a, m, lanes[t]);
  }
  const int warps = threads / 32;
  std::vector<rt::Reserve> reserve(warps, rt::Reserve{0, 0});
  std::vector<char> running(warps, 1);
  int left = warps, counter = 0;
  while (left > 0) {
    for (int w = 0; w < warps; ++w) {
      seed = seed * 1103515245u + 12345u;
      const int iters = 1 + static_cast<int>((seed >> 16) % 3u);
      for (int j = 0; j < iters && running[w]; ++j) {
        running[w] = warp_iteration<M, OP>(a, stop, m, &lanes[32 * w],
                                           reserve[w], chunk, threads,
                                           counter, stores, tally);
        if (!running[w]) --left;
      }
    }
  }
}

template <class M>
static void ops(int op, const rt::DynArgs& a, const M& m, int threads,
                int chunk, unsigned seed, int* stores, long long* tally) {
  if (op == 1) run<M, 1>(a, m, threads, chunk, seed, stores, tally);
  if (op == 2) run<M, 2>(a, m, threads, chunk, seed, stores, tally);
  if (op == 6) run<M, 6>(a, m, threads, chunk, seed, stores, tally);
  if (op == 8) run<M, 8>(a, m, threads, chunk, seed, stores, tally);
}

// ch, then rt_dynamic_step_strat's arguments less the counter and the
// stream
extern "C" void host_dyn_refill(int threads, int chunk, unsigned seed,
                                int* stores, long long* tally, int ch,
                                int op, void* const* in, void* const* out,
                                int n, int steps, float ds, float limit,
                                float offset, float bx0, float bx1,
                                float by0, float by1, RT_TABLE_PARAMS) {
  rt::DynArgs a;
  for (int k = 0; k < rt::NDSLOTS; ++k) {
    a.in.p[k] = in[k];
    a.out.p[k] = out[k];
  }
  a.n = n;
  a.steps = steps;
  a.ds = ds;
  a.limit = limit;
  a.offset = offset;
  a.box[0] = bx0;
  a.box[1] = bx1;
  a.box[2] = by0;
  a.box[3] = by1;
  if (ch == 6)
    ops(op, a, rt::Strat<6>{RT_TABLE}, threads, chunk, seed, stores, tally);
  if (ch == 4)
    ops(op, a, rt::Strat<4>{RT_TABLE}, threads, chunk, seed, stores, tally);
}
"""

_P, _I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """csrc/dynamic.cuh (with refill.cuh) built for the host by g++."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine to compile csrc/dynamic.cuh")
    tmp = tmp_path_factory.mktemp("dynamic_refill_host")
    src, lib = tmp / "dynamic_refill_host.cpp", tmp / "dynamic_refill_host.so"
    src.write_text(_SRC)
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", f"-I{build.CSRC}", "-o", str(lib),
                    str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    # threads, chunk, seed, stores, tally, then rt_dynamic_step_strat's
    # arguments less the counter and the stream
    so.host_dyn_refill.argtypes = (
        [_I, _I, ctypes.c_uint, _P, _P]
        + list(build._SIGNATURES["rt_dynamic_step_strat"][:-2]))
    so.host_dyn_refill.restype = None
    return so


@pytest.fixture
def ieee(monkeypatch):
    """torch.sqrt correctly rounded and torch.rsqrt as one division by it,
    as the header's host build computes them."""
    sqrt = torch.sqrt

    def ieee_sqrt(t):
        return sqrt(t.double()).float()

    monkeypatch.setattr(torch, "sqrt", ieee_sqrt)
    monkeypatch.setattr(torch, "rsqrt",
                        lambda t: kfu.div_exact(1.0, ieee_sqrt(t)))


class HostRun:
    """One host run: the output state, how often each ray was stored, and
    the refill loop's lane slots and steps."""

    def __init__(self, out, stores, slots, steps):
        self.out, self.stores, self.slots, self.steps = out, stores, slots, steps


def host_step(so, st, *, field, op, steps, delta_s, step_limit, offset=0.0,
              box, threads=0, chunk=1, seed=1):
    """dynamic.cuh on the host: ``threads`` 0 runs ``run_dyn`` on each ray,
    otherwise the refill loop's emulation with that many lanes, its warps
    taking at least ``chunk`` rays from the counter at once."""
    out = kd.DynState(*(torch.full_like(t, float("nan"))
                        if t.is_floating_point() else ~t for t in st))
    n = st.x.shape[0]
    stores = torch.zeros(n, dtype=torch.int32)
    tally = (ctypes.c_longlong * 2)()
    so.host_dyn_refill(threads, chunk, seed, stores.data_ptr(), tally,
                       field.ch, int(op[2:]), build.pointer_array(st),
                       build.pointer_array(out), n, int(steps),
                       float(np.float32(delta_s)), float(step_limit),
                       float(offset), *(float(v) for v in box),
                       field.table.data_ptr(), 0.0, field.y0, 0.0,
                       field.inv_hy, 0, field.ny)
    return HostRun(out, stores, tally[0], tally[1])


def same(a, b):
    """Two dynamic states equal in every plane, to the bit."""
    for name, x, y in zip(kd.DynState._fields, a, b):
        view = torch.uint8 if x.dtype == torch.bool else torch.int32
        assert torch.equal(x.view(view), y.view(view)), name


#: the vert_strat run's step (chip_smoke.py dyn_main_cases)
DS = float(np.float32(0.0193))


@pytest.fixture(scope="module")
def fan():
    """The vert box, both stratified tables of vert (trimmed at DS, as
    fast_dynamic trims them), and the vert_strat fan's first 333 rays:
    (-2, -2) at angles U[0.05, 1.5] (numpy seed 0)."""
    vert = rtt.scenario("vert")
    box = tuple(vert.box)
    tables = {
        6: kfu.strat_tables(rtt.compact_for_trace(
            rtt.build_stratified_medium("vert_heterogeneous", vert.box,
                                        **CPU), vert.box, DS)),
        4: kfu.strat_tables(rtt.compact_for_trace(
            rtt.build_c1_stratified("vert_heterogeneous", vert.box, **CPU),
            vert.box, DS)),
    }
    theta0 = np.random.default_rng(0).uniform(0.05, 1.5, 333)
    pos0 = np.full((333, 2), -2.0)
    return box, tables, pos0, theta0


#: (threads, chunk, seed) of the emulations: two warps taking one ray at a
#: time, three warps taking chunks of eight
LAYOUTS = ((64, 1, 1), (96, 8, 9))


@pytest.mark.parametrize("rays", [1, 31, 333])
@pytest.mark.parametrize("op", kd.DYN_FUSED_OPS)
@pytest.mark.parametrize("ch", [6, 4])
def test_refill_emulation_equals_plain(ch, op, rays, host, ieee, fan):
    """The emulated refill loop and run_dyn against dynamic_step_plain on
    the narrowed vert_strat fan: one launch of 300 steps, then a step limit
    of 120 below most lifetimes; every plane to the bit, every ray taken
    and stored exactly once."""
    box, tables, pos0, theta0 = fan
    field = tables[ch]
    st = kd.initial_dyn_state(pos0[:rays], theta0[:rays], **CPU)
    left = []
    for limit in (300.0, 120.0):
        kw = dict(field=field, op=op, steps=300, delta_s=DS,
                  step_limit=limit, box=box)
        plain = kd.dynamic_step_plain(st, offset=0.0, **kw)
        same(host_step(host, st, **kw).out, plain)
        for threads, chunk, seed in LAYOUTS:
            run = host_step(host, st, threads=threads, chunk=chunk,
                            seed=seed, **kw)
            same(run.out, plain)
            assert torch.equal(run.stores, torch.ones_like(run.stores))
        left.append(int((~plain.active).sum()))
    # in 300 steps some of the 333 rays leave the box and some do not; none
    # leaves in 120
    if rays == 333:
        assert 0 < left[0] < rays and left[1] == 0


@pytest.mark.parametrize("op", ["op6", "op8"])
@pytest.mark.parametrize("ch", [6, 4])
def test_refill_resume_chain_equals_one_launch(ch, op, host, ieee, fan):
    """A resume chain of uneven segments (1, 37, 120 and the rest of 300
    steps, offsets carried) through the emulated refill loop against one
    plain launch; every plane to the bit."""
    box, tables, pos0, theta0 = fan
    field = tables[ch]
    st = kd.initial_dyn_state(pos0[:217], theta0[:217], **CPU)
    kw = dict(field=field, op=op, delta_s=DS, step_limit=300.0, box=box)
    plain = kd.dynamic_step_plain(st, steps=300, offset=0.0, **kw)
    chain, done = st, 0
    for k, seg in enumerate((1, 37, 120, 300)):
        seg = min(seg, 300 - done)
        chain = host_step(host, chain, steps=seg, offset=float(done),
                          threads=64, chunk=8, seed=k, **kw).out
        done += seg
    assert done == 300
    same(chain, plain)


def test_refill_steps_fewer_lane_slots_than_one_ray_a_thread(host, ieee,
                                                             fan):
    """At the fan's full depth (every ray's whole life, lifetimes of
    157-405 steps), the emulated refill loop steps every live ray-step
    once and spends fewer lane slots than one ray a thread would: more of
    its slots step a live ray than the one-ray-a-thread warp efficiency."""
    box, tables, pos0, theta0 = fan
    field = tables[6]
    st = kd.initial_dyn_state(pos0, theta0, **CPU)
    kw = dict(field=field, op="op6", steps=450, delta_s=DS,
              step_limit=2000.0, box=box)
    plain = kd.dynamic_step_plain(st, offset=0.0, **kw)
    assert not bool(plain.active.any())
    life = np.rint(plain.dsim.double().numpy() / DS)
    assert life.min() < 0.5 * life.max()        # lifetimes differ widely
    run = host_step(host, st, threads=64, chunk=8, seed=3, **kw)
    same(run.out, plain)
    assert run.steps == int(life.sum())
    one_slots = sum(32 * life[i:i + 32].max() for i in range(0, len(life), 32))
    assert run.slots < one_slots
    assert run.steps / run.slots > warp_efficiency(life)
