"""The golden kernels' header (raytracing_tpu_torch/csrc/golden.cuh) built
for the host with g++, against the plain PyTorch version.

golden.cuh holds one ray's work as ``__host__ __device__`` functions on its
carry (``load_gold``, ``gold_step``, ``store_gold``; ``run_gold`` the whole
loop of one ray), with the second-order dual numbers, the momentum cost and
the Newton polish, on the media of media.cuh.  With the CUDA qualifiers
stubbed and contraction off (-ffp-contract=off), g++ builds the same
functions on the CPU.  The tests hold them to ``golden_step_plain`` on
every plane, to the bit:

* one ray a thread (``run_gold``, what ``golden_kernel`` runs): op5, op9,
  op10, op11, op10n and op11n on the analytic fisheye and vert fields and
  both stratified forms of vert, with and without the Welford tracker,
  under a step limit shorter than the launch and as a chain of two
  launches; the coarse bracket with its polish;
* an emulation of ``golden_kernel_refill``'s persistent loop (warps of 32
  lanes, a shared ray counter, one vote a warp, each warp's reserve taken
  in chunks by refill.cuh's ``refill_more`` and ``refill_next``, the warps'
  iterations interleaved in a seeded order) on the same cases and on the
  golden_strat_op11 fan at its full depth, whose rays live 121-395 steps
  of 4142: every ray is taken and stored exactly once.

The fast paths of the card (``rcp_fast``, ``rsqrt_fast``, ``sqrt_fast``,
``div_fast_pos``) are the IEEE operations on the host; the card holds them
to the same plain version (chip_smoke.py).  The analytic interface and the
bracket's reference-parity mode (``polish=0``, its ``cosf``/``sinf``) are
left to the card: glibc's ``expf``, ``cosf`` and ``sinf`` and PyTorch's CPU
``exp``, ``cos`` and ``sin`` may differ by an ulp.  PyTorch's CPU ``sqrt``
is not correctly rounded, so the plain version runs here with an IEEE
square root, and ``rsqrt`` as one division by it, which is what the
header's host build computes (on the card the kernel and ``torch.rsqrt``
share ``rsqrtf``).  Skipped where g++ is missing."""
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
from raytracing_tpu_torch.kernels import golden as kg  # noqa: E402

CPU = dict(device="cpu")

_STUBS = """#define __host__
#define __device__
#define __forceinline__ inline
#include <vector>
#include "golden.cuh"
"""
# one ray a thread (golden_kernel), and golden_kernel_refill's loop
# emulated warp by warp: each iteration of a warp mirrors one iteration of
# the kernel's loop (the freeze test and store, the vote, the leader's add
# on the counter, each lane's ray and reserve by refill_more and
# refill_next, the lanes' step)
_HOST_LOOP = r"""
struct Lane {
  rt::Gold s;
  int r = 0, i = 0;
  bool has = false, in = true;
};

static int popc(unsigned v) { return __builtin_popcount(v); }

template <class M, bool C, bool N, bool I>
static bool warp_iteration(const rt::GoldenArgs& a, const rt::GoldConst& k,
                           int stop, const M& m, Lane* L, rt::Reserve& w,
                           int chunk, long long taken, int& counter,
                           int* stores, long long* tally) {
  bool live[32] = {};
  unsigned need = 0, in = 0;
  for (int l = 0; l < 32; ++l) {
    if (!L[l].in) continue;
    in |= 1u << l;
    live[l] = L[l].has && L[l].i < stop && L[l].s.active;
    if (L[l].has && !live[l]) {
      rt::store_gold(a, L[l].r, L[l].s);
      ++stores[L[l].r];
      L[l].has = false;
    }
    if (!L[l].has) need |= 1u << l;
  }
  if (need != 0u) {
    const int kk = popc(need);
    const int more = rt::refill_more(w, kk, chunk);
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
      const long long next = rt::refill_next(mine, kk, rank, more, taken,
                                             base);
      w = mine;
      if (!(need >> l & 1u)) continue;
      if (next < a.n) {
        L[l].r = static_cast<int>(next);
        L[l].has = true;
        L[l].i = 0;
        rt::load_gold<M, I>(a, k, m, L[l].r, L[l].s);
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
      rt::gold_step<M, C, N, I>(a, k, m, L[l].s, a.stats != 0);
      ++L[l].i;
      ++tally[1];   // steps taken
    }
  }
  return true;
}

template <class M, bool C, bool N, bool I>
static void run(const rt::GoldenArgs& a, const M& m, int threads, int chunk,
                unsigned seed, int* stores, long long* tally) {
  if (threads == 0) {
    for (int r = 0; r < a.n; ++r) {
      rt::run_gold<M, C, N, I>(a, m, r);
      ++stores[r];
    }
    return;
  }
  const rt::GoldConst k = rt::gold_const(a);
  const int stop = rt::step_budget(a.steps, k.offset, k.limit);
  std::vector<Lane> lanes(threads);
  for (int t = 0; t < threads; ++t) {
    lanes[t].r = t;
    lanes[t].has = t < a.n;
    if (lanes[t].has) rt::load_gold<M, I>(a, k, m, t, lanes[t].s);
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
        running[w] = warp_iteration<M, C, N, I>(
            a, k, stop, m, &lanes[32 * w], reserve[w], chunk, threads,
            counter, stores, tally);
        if (!running[w]) --left;
      }
    }
  }
}

template <class M>
static void variants(int curv, int newton, int iso, const rt::GoldenArgs& a,
                     const M& m, int threads, int chunk, unsigned seed,
                     int* stores, long long* tally) {
  switch ((curv ? 4 : 0) | (newton ? 2 : 0) | (iso ? 1 : 0)) {
    case 0: return run<M, false, false, false>(a, m, threads, chunk, seed,
                                               stores, tally);
    case 1: return run<M, false, false, true>(a, m, threads, chunk, seed,
                                              stores, tally);
    case 2: return run<M, false, true, false>(a, m, threads, chunk, seed,
                                              stores, tally);
    case 4: return run<M, true, false, false>(a, m, threads, chunk, seed,
                                              stores, tally);
    case 5: return run<M, true, false, true>(a, m, threads, chunk, seed,
                                             stores, tally);
    case 6: return run<M, true, true, false>(a, m, threads, chunk, seed,
                                             stores, tally);
  }
}

// medium 0: the analytic field `code`; 1: a stratified table, ch = code
extern "C" void host_golden(int medium, int code, int threads, int chunk,
                            unsigned seed, int* stores, long long* tally,
                            RT_GOLDEN_PARAMS, RT_TABLE_PARAMS) {
  const rt::GoldenArgs a = RT_GOLDEN_ARGS;
  if (medium == 0 && code == 0)
    variants(curv, newton, iso, a, rt::Analytic<0>{}, threads, chunk, seed,
             stores, tally);
  if (medium == 0 && code == 1)
    variants(curv, newton, iso, a, rt::Analytic<1>{}, threads, chunk, seed,
             stores, tally);
  if (medium == 1 && code == 6)
    variants(curv, newton, iso, a, rt::Strat<6>{RT_TABLE}, threads, chunk,
             seed, stores, tally);
  if (medium == 1 && code == 4)
    variants(curv, newton, iso, a, rt::Strat<4>{RT_TABLE}, threads, chunk,
             seed, stores, tally);
}
"""

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """csrc/golden.cuh built for the host by g++ (-O2 -ffp-contract=off,
    the CUDA qualifiers stubbed)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine to compile csrc/golden.cuh")
    tmp = tmp_path_factory.mktemp("golden_host")
    src, lib = tmp / "golden_host.cpp", tmp / "golden_host.so"
    src.write_text(_STUBS + _HOST_LOOP)
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", f"-I{build.CSRC}", "-o", str(lib),
                    str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    # medium, code, threads, chunk, seed, stores, tally, then
    # rt_golden_step's arguments after field up to the counter, the table's
    so.host_golden.argtypes = (
        [_I, _I, _I, _I, ctypes.c_uint, _P, _P]
        + list(build._SIGNATURES["rt_golden_step"][1:-1])
        + [_P, _F, _F, _F, _F, _I, _I])
    so.host_golden.restype = None
    return so


class HostRun:
    """What one host run gives: the output state, how often each ray was
    stored, and the refill loop's lane slots and steps."""

    def __init__(self, out, stores, slots, steps):
        self.out, self.stores, self.slots, self.steps = out, stores, slots, steps


def host_step(so, st, scal, *, field, op, steps, box, iters, polish,
              threads=0, chunk=1, seed=1):
    """golden.cuh on the host: ``threads`` 0 runs ``run_gold`` on each ray,
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
    so.host_golden(medium, code, threads, chunk, seed, stores.data_ptr(),
                   tally, *kg._variant(op), int(st.mom_count is not None),
                   build.pointer_array(st), build.pointer_array(out), n,
                   int(steps), scal.data_ptr(), iters, polish,
                   *(float(v) for v in box), kfu.CURV_TOL,
                   *kg.bracket_constants(iters), None, *table)
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


@pytest.fixture(scope="module")
def vert_tables():
    vert = rtt.scenario("vert")
    return {6: kfu.strat_tables(rtt.build_stratified_medium(
                "vert_heterogeneous", vert.box, device="cpu")),
            4: kfu.strat_tables(rtt.build_c1_stratified(
                "vert_heterogeneous", vert.box, device="cpu"))}


RAYS = 100


def _case(kind, vert_tables):
    """(field, pos0, theta0, delta_s, gamma, box) of one medium: fisheye
    rays over the unit square leaving a box of half-width 1.2, or the vert
    fan in its box at aniso's gamma, on the analytic field or a stratified
    table (parity 6, C1 4)."""
    rng = np.random.default_rng(3)
    if kind == "fisheye":
        pos0 = rng.uniform(-1.0, 1.0, (RAYS, 2))
        theta0 = rng.uniform(0.0, 2.0 * np.pi, RAYS)
        return "fisheye", pos0, theta0, 0.02, 1.5, (-1.2, 1.2, -1.2, 1.2)
    pos0, theta0 = H.fan_vert(rng, RAYS)
    field = ("vert_heterogeneous" if kind == "vert"
             else vert_tables[int(kind[-1])])
    return field, pos0, theta0, 0.05, rtt.scenario("aniso").gamma, \
        H.VERT_BOX


def _check(host, st, field, op, ds, gamma, box, iters, polish, chains):
    """One launch under a step limit shorter than the launch, and a chain
    of two launches (offset k) under the same limit, against the plain
    version, one ray a thread and through the emulated refill loop."""
    steps, limit, cut = 60, 47.0, 17
    kw = dict(field=field, op=op, box=box, iters=iters, polish=polish)

    def scal(off):
        return kg.golden_scalars(ds, gamma, limit, off, iters, **CPU)

    plain = kg.golden_step_plain(st, scal(0.0), steps=steps, **kw)
    for threads, chunk in chains:
        one = host_step(host, st, scal(0.0), steps=steps, threads=threads,
                        chunk=chunk, **kw)
        same(one.out, plain)
        assert torch.equal(one.stores, torch.ones_like(one.stores))
        first = host_step(host, st, scal(0.0), steps=cut, threads=threads,
                          chunk=chunk, **kw).out
        two = host_step(host, first, scal(float(cut)), steps=steps - cut,
                        threads=threads, chunk=chunk, seed=7, **kw)
        same(two.out, plain)


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("op", list(kg.GOLDEN_OPS))
@pytest.mark.parametrize("kind", ["fisheye", "vert", "strat6", "strat4"])
def test_header_loop_on_the_host_equals_plain(kind, op, stats, host, ieee,
                                              vert_tables):
    """run_gold and the emulated refill loop against golden_step_plain on
    the production schedule (the closed-form seed and two Newton steps;
    op10n/op11n's three), every plane to the bit, with and without the
    Welford tracker."""
    field, pos0, theta0, ds, gamma, box = _case(kind, vert_tables)
    st = kg.initial_state(op, pos0, theta0, gamma, field=field,
                          with_stats=stats, **CPU)
    iters, polish = kg.golden_schedule()
    _check(host, st, field, op, ds, gamma, box, iters, polish,
           ((0, 1), (64, 1), (64, 8)))


@pytest.mark.parametrize("op", ["op5", "op11", "op10n"])
@pytest.mark.parametrize("kind", ["vert", "strat6"])
def test_header_bracket_schedule_equals_plain(kind, op, host, ieee,
                                              vert_tables):
    """The coarse bracket with its polish (iters 12, polish 2): the
    transcendental-free bracket's rotations and the polish from its final
    midpoint, to the bit, with the tracker."""
    field, pos0, theta0, ds, gamma, box = _case(kind, vert_tables)
    st = kg.initial_state(op, pos0, theta0, gamma, field=field,
                          with_stats=True, **CPU)
    iters, polish = kg.golden_schedule(2, kg.GOLD_COARSE_ITERS)
    _check(host, st, field, op, ds, gamma, box, iters, polish,
           ((0, 1), (64, 8)))


@pytest.fixture(scope="module")
def golden_strat_op11():
    """The golden_strat_op11 run of the sampled main path at a reduced ray
    count: aniso's 31 launch angles resized (bench.launch_fan), the parity
    vert table trimmed for aniso's box at the reference table's op11 step
    as fast_trace trims it, the full depth, with the tracker."""
    from raytracing_tpu_torch.bench import launch_fan
    scen = rtt.scenario("aniso")
    ds, div = calibrated_with_fallback("op11", "aniso")
    steps = scen.max_size(ds, div, 1) - 1
    med = rtt.compact_for_trace(rtt.build_stratified_medium(
        "vert_heterogeneous", rtt.scenario("vert").box, device="cpu"),
        scen.box, ds)
    pos0, theta0 = launch_fan(scen, 31 * 3 + 17)
    return kfu.strat_tables(med), pos0, theta0, float(ds), scen.gamma, \
        steps, tuple(scen.box)


def warp_efficiency(dsim, ds, steps):
    """Share of a one-ray-a-thread launch's lane-steps that step a live ray:
    each ray's lifetime (dist_sim / ds, as chip_smoke.py counts it) over 32
    times the longest lifetime of its warp."""
    from raytracing_tpu_torch.bench import warp_efficiency as eff
    return eff(np.minimum(np.rint(dsim.double().numpy() / ds), steps))


def test_refill_emulation_on_the_golden_strat_fan(host, ieee,
                                                  golden_strat_op11):
    """The emulated refill loop on the golden_strat_op11 fan at its full
    depth (rays of very different lifetimes in every warp), the tracker
    carried across refills, and a resume chain of uneven segments: every
    ray taken and stored exactly once, every plane equal to
    golden_step_plain, with more of the lane slots stepping a live ray than
    one ray a thread gives."""
    tables, pos0, theta0, ds, gamma, steps, box = golden_strat_op11
    st = kg.initial_state("op11", pos0, theta0, gamma, field=tables,
                          with_stats=True, **CPU)
    iters, polish = kg.golden_schedule()
    kw = dict(field=tables, op="op11", box=box, iters=iters, polish=polish)

    def scal(off):
        return kg.golden_scalars(ds, gamma, steps, off, iters, **CPU)

    # the plain version to the last ray's end, not the 4142-step budget
    plain = kg.golden_step_plain(st, scal(0.0), steps=450, **kw)
    assert not plain.active.any()
    life = np.rint(plain.dsim.double().numpy() / ds)
    assert life.min() < 0.5 * life.max()      # lifetimes differ widely
    for threads, chunk, seed in ((64, 1, 1), (32, 32, 5), (96, 8, 9)):
        run = host_step(host, st, scal(0.0), steps=steps, threads=threads,
                        chunk=chunk, seed=seed, **kw)
        same(run.out, plain)
        assert torch.equal(run.stores, torch.ones_like(run.stores))
        assert run.steps == int(life.sum())
    refill = host_step(host, st, scal(0.0), steps=steps, threads=64, **kw)
    assert refill.steps / refill.slots > warp_efficiency(plain.dsim, ds,
                                                         steps)
    chain, done = st, 0
    for k, seg in enumerate((1, 120, 37, 200, steps)):
        seg = min(seg, steps - done)
        chain = host_step(host, chain, scal(float(done)), steps=seg,
                          threads=64, chunk=8, seed=k, **kw).out
        done += seg
    assert done == steps
    same(chain, plain)


@pytest.mark.parametrize("op", ["op5", "op11", "op11n"])
def test_guard_model_counts_the_fast_paths_failures(op, vert_tables):
    """golden_step_plain's model of the kernels' guards (``guards=``)
    changes no plane, counts every ray-step it moves, and counts none as a
    guard failure on the vert fan at an ordinary step, every one at
    delta_s = 1e-17 (the position's ds^2 / 2n and the chord's square below
    the fast paths' 2^-100)."""
    field, pos0, theta0, ds, gamma, box = _case("strat6", vert_tables)
    st = kg.initial_state(op, pos0, theta0, gamma, field=field,
                          with_stats=True, **CPU)
    iters, polish = kg.golden_schedule()
    kw = dict(field=field, op=op, steps=40, box=box, iters=iters,
              polish=polish)
    for step, failures in ((ds, 0.0), (1e-17, None)):
        scal = kg.golden_scalars(step, gamma, 40.0, 0.0, iters, **CPU)
        g = torch.zeros(2, dtype=torch.float64)
        same(kg.golden_step_plain(st, scal, guards=g, **kw),
             plain := kg.golden_step_plain(st, scal, **kw))
        moved = float(np.rint(plain.mom_count.double().numpy() - 1.0).sum())
        assert g[1] == moved > 0
        assert g[0] == (moved if failures is None else failures)
