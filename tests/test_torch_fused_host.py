"""The fused kernels' header (raytracing_tpu_torch/csrc/fused.cuh) built for
the host with g++, against the plain PyTorch version.

fused.cuh holds one ray's work as ``__host__ __device__`` functions on its
carry (``load_ray``, ``budget``, ``step``, ``store_ray``; ``run_ray`` the
whole loop of one ray), on the media of media.cuh.  With the CUDA
qualifiers stubbed and contraction off (-ffp-contract=off), g++ builds the
same functions on the CPU.  The tests hold them to ``fused_step_plain`` on
every plane, to the bit:

* one ray a thread (``run_ray``, what ``fused_kernel`` runs), on the
  analytic fisheye and vert fields and both stratified forms, every op, with
  step limits, offsets and resume chains;
* an emulation of ``fused_kernel_refill``'s persistent loop (warps of 32
  lanes, a shared ray counter, one vote a warp, each warp's reserve of
  rays taken in chunks, the warps' iterations interleaved in a seeded
  order), on the same cases and on the
  interface_strat fan at its full depth, whose rays live 288-1120 steps:
  every ray is taken and stored exactly once.

The analytic interface is left to the card: glibc's ``expf`` and PyTorch's
CPU ``exp`` differ by an ulp, where on the card both are libdevice's.
PyTorch's CPU ``sqrt`` is not correctly rounded (an ulp off on ~1 % of
float32 inputs), so the plain version runs here with an IEEE square root,
and ``rsqrt`` as one division by it, which is what the header's host build
computes (on the card the kernel and ``torch.rsqrt`` share ``rsqrtf``).
Skipped where g++ is missing."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.calibrated import calibrated_with_fallback  # noqa: E402
from raytracing_tpu_torch.kernels import build  # noqa: E402
from raytracing_tpu_torch.kernels import fused as kfu  # noqa: E402

CPU = dict(device="cpu")

_STUBS = """#define __host__
#define __device__
#define __forceinline__ inline
#include <vector>
#include "fused.cuh"
"""
# one ray a thread (fused_kernel), and fused_kernel_refill's loop emulated
# warp by warp: each iteration of a warp mirrors one iteration of the
# kernel's loop (the freeze test and store, the vote, the leader's add on
# the counter, each lane's ray and reserve by the header's refill_more and
# refill_next, the lanes' step)
_HOST_LOOP = r"""
struct Lane {
  rt::Ray s;
  int r = 0, i = 0, stop = 0;
  bool has = false, in = true;
};

static int popc(unsigned v) { return __builtin_popcount(v); }

// one iteration of the loop for the 32 lanes L; false once no lane is left
template <class M, int OP>
static bool warp_iteration(const rt::FusedArgs& a, const M& m, Lane* L,
                           rt::Reserve& w, int chunk, long long taken,
                           int& counter, int* stores, long long* tally) {
  bool live[32] = {};
  unsigned need = 0, in = 0;
  for (int l = 0; l < 32; ++l) {
    if (!L[l].in) continue;
    in |= 1u << l;
    live[l] = L[l].has && L[l].i < L[l].stop && L[l].s.active;
    if (L[l].has && !live[l]) {
      rt::store_ray<OP>(a, L[l].r, L[l].s);
      ++stores[L[l].r];
      L[l].has = false;
    }
    if (!L[l].has) need |= 1u << l;
  }
  if (need != 0u) {
    // every lane in the loop computes the vote from the same reserve; the
    // leader alone adds to the counter
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
        rt::load_ray<M, OP>(a, m, L[l].r, L[l].s);
        L[l].stop = rt::budget(a, L[l].s);
        live[l] = 0 < L[l].stop && L[l].s.active;
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
      rt::step<M, OP>(a, m, L[l].s, L[l].i, a.stats != 0);
      ++L[l].i;
      ++tally[1];   // steps taken
    }
  }
  return true;
}

// threads lanes (a multiple of 32); each round runs every warp still in the
// loop for 1-3 iterations, drawn from a seeded generator
template <class M, int OP>
static void refill(const rt::FusedArgs& a, const M& m, int threads,
                   int chunk, unsigned seed, int* stores, long long* tally) {
  std::vector<Lane> lanes(threads);
  for (int t = 0; t < threads; ++t) {
    lanes[t].r = t;
    lanes[t].has = t < a.n;
    if (lanes[t].has) {
      rt::load_ray<M, OP>(a, m, t, lanes[t].s);
      lanes[t].stop = rt::budget(a, lanes[t].s);
    }
  }
  const int warps = threads / 32;
  std::vector<rt::Reserve> reserve(warps, rt::Reserve{0, 0});
  std::vector<char> running(warps, 1);
  int left = warps, counter = 0;
  while (left > 0) {
    for (int w = 0; w < warps; ++w) {
      seed = seed * 1103515245u + 12345u;
      const int iters = 1 + static_cast<int>((seed >> 16) % 3u);
      for (int k = 0; k < iters && running[w]; ++k) {
        running[w] = warp_iteration<M, OP>(a, m, &lanes[32 * w], reserve[w],
                                           chunk, threads, counter, stores,
                                           tally);
        if (!running[w]) --left;
      }
    }
  }
}

template <class M, int OP>
static void run(const rt::FusedArgs& a, const M& m, int threads, int chunk,
                unsigned seed, int* stores, long long* tally) {
  if (threads == 0) {
    for (int r = 0; r < a.n; ++r) {
      rt::run_ray<M, OP>(a, m, r);
      ++stores[r];
    }
  } else {
    refill<M, OP>(a, m, threads, chunk, seed, stores, tally);
  }
}

template <class M>
static void ops(const rt::FusedArgs& a, int op, const M& m, int threads,
                int chunk, unsigned seed, int* stores, long long* tally) {
  switch (op) {
    case 1: return run<M, 1>(a, m, threads, chunk, seed, stores, tally);
    case 2: return run<M, 2>(a, m, threads, chunk, seed, stores, tally);
    case 3: return run<M, 3>(a, m, threads, chunk, seed, stores, tally);
    case 4: return run<M, 4>(a, m, threads, chunk, seed, stores, tally);
    case 6: return run<M, 6>(a, m, threads, chunk, seed, stores, tally);
    case 7: return run<M, 7>(a, m, threads, chunk, seed, stores, tally);
    case 8: return run<M, 8>(a, m, threads, chunk, seed, stores, tally);
    case 12: return run<M, 12>(a, m, threads, chunk, seed, stores, tally);
  }
}

// for each (offset, limit): budget's step count, and the first i in [0,
// steps] where the plain version's step-limit test fails (steps if none)
extern "C" void host_budget(const float* offset, const float* limit, int n,
                            int steps, int* budget, int* first) {
  for (int k = 0; k < n; ++k) {
    rt::FusedArgs a{};
    a.steps = steps;
    a.offset = offset[k];
    rt::Ray s{};
    s.active = true;
    s.limit = limit[k];
    budget[k] = rt::budget(a, s);
    int i = 0;
    while (i < steps && (float)i + a.offset < s.limit) ++i;
    first[k] = i;
  }
}

// medium 0: the analytic field `code`; 1: a stratified table, ch = code
extern "C" void host_fused(int medium, int code, int threads, int chunk,
                           unsigned seed, int* stores, long long* tally,
                           RT_FUSED_PARAMS, RT_TABLE_PARAMS) {
  const rt::FusedArgs a = RT_FUSED_ARGS;
  if (medium == 0 && code == 0)
    ops(a, op, rt::Analytic<0>{}, threads, chunk, seed, stores, tally);
  if (medium == 0 && code == 1)
    ops(a, op, rt::Analytic<1>{}, threads, chunk, seed, stores, tally);
  if (medium == 1 && code == 6)
    ops(a, op, rt::Strat<6>{RT_TABLE}, threads, chunk, seed, stores, tally);
  if (medium == 1 && code == 4)
    ops(a, op, rt::Strat<4>{RT_TABLE}, threads, chunk, seed, stores, tally);
}
"""

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """csrc/fused.cuh built for the host by g++ (-O2 -ffp-contract=off, the
    CUDA qualifiers stubbed)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine to compile csrc/fused.cuh")
    tmp = tmp_path_factory.mktemp("fused_host")
    src, lib = tmp / "fused_host.cpp", tmp / "fused_host.so"
    src.write_text(_STUBS + _HOST_LOOP)
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", f"-I{build.CSRC}", "-o", str(lib),
                    str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    # medium, code, threads, chunk, seed, stores, tally, then
    # rt_fused_step's arguments after field up to curv_tol, then the table's
    so.host_fused.argtypes = ([_I, _I, _I, _I, ctypes.c_uint, _P, _P]
                              + list(build._SIGNATURES["rt_fused_step"][1:-2])
                              + [_P, _F, _F, _F, _F, _I, _I])
    so.host_fused.restype = None
    so.host_budget.argtypes = [_P, _P, _I, _I, _P, _P]
    so.host_budget.restype = None
    return so


class HostRun:
    """What one host run gives: the output state, how often each ray was
    stored, and the refill loop's lane slots and steps."""

    def __init__(self, out, stores, slots, steps):
        self.out, self.stores, self.slots, self.steps = out, stores, slots, steps


def host_step(so, st, *, field, op, steps, delta_s, step_limit, offset=0.0,
              box, threads=0, chunk=1, seed=1):
    """fused.cuh on the host: ``threads`` 0 runs ``run_ray`` on each ray,
    otherwise the refill loop's emulation with that many lanes, its warps
    taking at least ``chunk`` rays from the counter at once."""
    out = kfu.ResumeState(*(None if t is None else
                            (torch.full_like(t, float("nan"))
                             if t.is_floating_point() else ~t)
                            for t in st))
    n = st.x.shape[0]
    stores = torch.zeros(n, dtype=torch.int32)
    tally = (ctypes.c_longlong * 2)()
    if isinstance(field, kfu.StratTables):
        medium, code, table = 1, field.ch, (
            field.table.data_ptr(), 0.0, field.y0, 0.0, field.inv_hy, 0,
            field.ny)
    else:
        medium, code, table = 0, kfu.FIELD_CODES[field], (
            None, 0.0, 0.0, 0.0, 0.0, 0, 0)
    so.host_fused(medium, code, threads, chunk, seed, stores.data_ptr(),
                  tally,
                  int(op[2:]), int(st.mom_count is not None),
                  build.pointer_array(st), build.pointer_array(out), n,
                  int(steps), float(np.float32(delta_s)), float(step_limit),
                  float(offset), *(float(v) for v in box), kfu.CURV_TOL,
                  *table)
    return HostRun(out, stores, tally[0], tally[1])


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


def same(a, b):
    """Two resume states equal in every plane, to the bit."""
    for name, x, y in zip(kfu.ResumeState._fields, a, b):
        assert (x is None) == (y is None), name
        if x is not None:
            assert torch.equal(x.view(torch.uint8) if x.dtype == torch.bool
                               else x.view(torch.int32),
                               y.view(torch.uint8) if y.dtype == torch.bool
                               else y.view(torch.int32)), name


def test_budget_is_where_the_freeze_test_first_holds(host):
    """budget(), the loops' step count before the step limit, is the first
    step at which the plain version's test (float)i + offset < limit
    fails: fractional, negative, huge and NaN limits and offsets, and
    offsets past 2**24 where float32 steps skip integers."""
    rng = np.random.default_rng(11)
    offs = np.concatenate([[0.0, 0.0, 5.0, 2.0 ** 24, 2.0 ** 24 + 7.0, 1e30,
                            -3.5, np.nan, 0.0, 3.0],
                           rng.uniform(-50, 3000, 200),
                           2.0 ** 24 + rng.integers(0, 64, 40)])
    lims = np.concatenate([[0.0, 7557.0, 12.5, 2.0 ** 24 + 100.0,
                            2.0 ** 24 + 33.0, 1e30, 2.0, 5.0, np.nan, -np.inf],
                           rng.uniform(-50, 9000, 200),
                           2.0 ** 24 + rng.integers(0, 3000, 40)])
    offs, lims = offs.astype(np.float32), lims.astype(np.float32)
    n, steps = len(offs), 4000
    got, want = np.zeros(n, np.int32), np.zeros(n, np.int32)
    host.host_budget(offs.ctypes.data, lims.ctypes.data, n, steps,
                     got.ctypes.data, want.ctypes.data)
    assert (got == want).all()
    assert 0 < (want % steps).sum() and (want == steps).any()


@pytest.fixture(scope="module")
def vert_tables():
    vert = rtt.scenario("vert")
    return {6: kfu.strat_tables(rtt.build_stratified_medium(
                "vert_heterogeneous", vert.box, device="cpu")),
            4: kfu.strat_tables(rtt.build_c1_stratified(
                "vert_heterogeneous", vert.box, device="cpu"))}


RAYS = 200


def _case(kind, vert_tables):
    """(field, pos0, theta0, delta_s, box, stats) of one medium: fisheye rays
    over the unit square leaving a box of half-width 1.2, the vert fan in
    its box, on the analytic field or a stratified table (parity 6, C1 4)."""
    rng = np.random.default_rng(3)
    if kind == "fisheye":
        pos0 = rng.uniform(-1.0, 1.0, (RAYS, 2))
        theta0 = rng.uniform(0.0, 2.0 * np.pi, RAYS)
        return "fisheye", pos0, theta0, 0.02, (-1.2, 1.2, -1.2, 1.2), False
    pos0, theta0 = H.fan_vert(rng, RAYS)
    field = ("vert_heterogeneous" if kind == "vert"
             else vert_tables[int(kind[-1])])
    return field, pos0, theta0, 0.05, H.VERT_BOX, True


@pytest.mark.parametrize("op", kfu.FUSED_OPS)
@pytest.mark.parametrize("kind", ["fisheye", "vert", "strat6", "strat4"])
def test_header_loop_on_the_host_equals_plain(kind, op, host, ieee,
                                              vert_tables):
    """run_ray and the emulated refill loop against fused_step_plain, every
    plane to the bit: one launch under a step limit shorter than the launch,
    and a chain of two launches (offset k) under the same limit."""
    field, pos0, theta0, ds, box, stats = _case(kind, vert_tables)
    st = kfu.initial_state(op, pos0, theta0, field=field, with_stats=stats,
                           **CPU)
    steps, limit, cut = 90, 70.0, 23
    kw = dict(field=field, op=op, delta_s=ds, step_limit=limit, box=box)
    plain = kfu.fused_step_plain(st, steps=steps, offset=0.0, **kw)
    for threads, chunk in ((0, 1), (64, 1), (64, 8)):
        one = host_step(host, st, steps=steps, threads=threads, chunk=chunk,
                        **kw)
        same(one.out, plain)
        assert torch.equal(one.stores, torch.ones_like(one.stores))
        first = host_step(host, st, steps=cut, threads=threads, chunk=chunk,
                          **kw).out
        two = host_step(host, first, steps=steps - cut, offset=float(cut),
                        threads=threads, chunk=chunk, seed=7, **kw)
        same(two.out, plain)


@pytest.fixture(scope="module")
def interface_strat():
    """The interface_strat run of the sampled main path, at a reduced ray
    count: the scenario's 42 launch angles resized (bench.launch_fan), the
    parity table trimmed for its box and step as fast_trace trims it, the
    reference table's op6 step, and the full depth."""
    from raytracing_tpu_torch.bench import launch_fan
    scen = rtt.scenario("interface")
    ds, div = calibrated_with_fallback("op6", "interface")
    steps = scen.max_size(ds, div, 1) - 1
    med = rtt.compact_for_trace(rtt.build_stratified_medium(
        "interface", scen.box, device="cpu"), scen.box, ds)
    pos0, theta0 = launch_fan(scen, 42 * 5 + 17)
    return kfu.strat_tables(med), pos0, theta0, float(ds), steps, \
        tuple(scen.box)


def warp_efficiency(dsim, ds, steps):
    """Share of a one-ray-a-thread launch's lane-steps that step a live ray:
    each ray's lifetime (dist_sim / ds, as chip_smoke.py counts it) over 32
    times the longest lifetime of its warp."""
    life = np.minimum(np.rint(dsim.double().numpy() / ds), steps)
    pad = -len(life) % 32
    warps = np.concatenate([life, np.zeros(pad)]).reshape(-1, 32)
    return float(life.sum() / (32.0 * warps.max(1)).sum())


@pytest.mark.parametrize("op,stats", [("op6", False), ("op7", True)])
def test_refill_emulation_on_the_interface_fan(op, stats, host, ieee,
                                               interface_strat):
    """The emulated refill loop on the interface_strat fan at its full
    depth (rays of very different lifetimes in every warp), op7's window
    and the Welford stats carried across refills: every ray taken and
    stored exactly once, every plane equal to fused_step_plain, with more
    of the lane slots stepping a live ray than one ray a thread gives."""
    tables, pos0, theta0, ds, steps, box = interface_strat
    st = kfu.initial_state(op, pos0, theta0, field=tables, with_stats=stats,
                           **CPU)
    kw = dict(field=tables, op=op, delta_s=ds, step_limit=steps, box=box)
    plain = kfu.fused_step_plain(st, steps=steps, offset=0.0, **kw)
    life = np.rint(plain.dsim.double().numpy() / ds)
    assert life.min() < 0.3 * life.max()      # lifetimes differ widely
    for threads, chunk, seed in ((96, 1, 1), (32, 32, 5), (256, 8, 9)):
        run = host_step(host, st, steps=steps, threads=threads, chunk=chunk,
                        seed=seed, **kw)
        same(run.out, plain)
        assert torch.equal(run.stores, torch.ones_like(run.stores))
        assert run.steps == int(life.sum())
    refill = host_step(host, st, steps=steps, threads=96, **kw)
    assert refill.steps / refill.slots > warp_efficiency(plain.dsim, ds,
                                                         steps)


def test_refill_emulation_resume_chain_and_short_limit(host, ieee,
                                                       interface_strat):
    """A resume chain of uneven segments through the emulated refill loop
    equals one launch and the plain version; a step limit shorter than
    most lifetimes freezes every ray at it."""
    tables, pos0, theta0, ds, steps, box = interface_strat
    st = kfu.initial_state("op6", pos0, theta0, field=tables,
                           with_stats=True, **CPU)
    kw = dict(field=tables, op="op6", delta_s=ds, box=box)
    one = host_step(host, st, steps=steps, step_limit=steps, threads=64,
                    chunk=8, **kw).out
    same(one, kfu.fused_step_plain(st, steps=steps, step_limit=steps,
                                   offset=0.0, **kw))
    chain, done = st, 0
    for k, seg in enumerate((1, 300, 37, 2000, steps)):
        seg = min(seg, steps - done)
        chain = host_step(host, chain, steps=seg, step_limit=steps,
                          offset=float(done), threads=64, chunk=8, seed=k,
                          **kw).out
        done += seg
    assert done == steps
    same(chain, one)
    short = 150.0
    cut = host_step(host, st, steps=steps, step_limit=short, threads=64,
                    chunk=8, **kw).out
    same(cut, kfu.fused_step_plain(st, steps=int(short), step_limit=short,
                                   offset=0.0, **kw))
    assert torch.equal(cut.mom_count, torch.full_like(cut.mom_count,
                                                      short + 1.0))
