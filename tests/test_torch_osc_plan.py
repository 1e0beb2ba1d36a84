"""Frozen RMA access plans of the PyTorch port (``osc/plan.py``, in-process
half) held against the JAX package.

The in-process cases of ``tests/test_osc_plan.py`` run as one script on
both packages and compare what they observe: the parity matrix (fence,
passive lock and PSCW epochs x float32/int32, three epochs each: the
capture and two replays), indexed CAS and fetch parity, ten epochs with
one plan and one built close, the orchestration timer fed by both paths,
the oversized epoch staying interpreted, a cvar write re-planning, a
divergence dropping the plan loudly, free evicting plans, an unhashable
payload skipped, a same-named user op getting its own plan, zero
registry reads in steady closes, and ``cache_stats``. Values are held
BITWISE: against the JAX package's planned closes, and against the
port's own interpreted close (``osc_compiled`` off). On the CPU a plan
is the unrolled close; its CUDA-graph leg runs on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``). The wire
legs (``BatchTemplate``, ``_pack_batch``, ``OscTuning``, the
cross-process job) are in ``tests/test_torch_wire_win.py``.
"""

import numpy as np
import pytest
import torch

import ompi_release_tpu as jmpi
from ompi_release_tpu import ops as jops
from ompi_release_tpu import osc as josc
from ompi_release_tpu.mca import pvar as jpvar
from ompi_release_tpu.mca import var as jvar
from ompi_release_tpu.ops.op import Op as JOp
from ompi_release_tpu.osc import plan as jplan
from ompi_release_tpu.osc.window import _PendingOp as JPendingOp
import ompi_release_tpu_torch as tmpi
from ompi_release_tpu_torch import ops as tops
from ompi_release_tpu_torch import osc as tosc
from ompi_release_tpu_torch.mca import pvar as tpvar
from ompi_release_tpu_torch.mca import var as tvar
from ompi_release_tpu_torch.ops.op import Op as TOp
from ompi_release_tpu_torch.osc import plan as tplan
from ompi_release_tpu_torch.osc.window import _PendingOp as TPendingOp
from ompi_release_tpu_torch.runtime import runtime as trt

N = 8
#: the pvars this module reads; the aggregates' min and max are not
#: differences, so both packages' must start from the same history
OSC_PVARS = ("osc_orchestration_seconds", "osc_plan_cache_hits",
             "osc_plan_programs", "osc_plans_frozen")


def reset_osc_pvars():
    """Zero the module's pvars in both packages: an earlier test file on
    the same process (any JAX file that runs epochs, e.g.
    ``tests/test_osc.py``) leaves the JAX package's aggregates with a
    max of 1 that a fresh port process does not have."""
    for registry in (jpvar.PVARS, tpvar.PVARS):
        for name in OSC_PVARS:
            p = registry.lookup(name)
            if p is not None:
                p.reset()


@pytest.fixture(scope="module")
def worlds():
    jworld = jmpi.init()
    trt._reset_for_tests()
    tworld = tmpi.init(cli_args=["--mca", "runtime_virtual_ranks", str(N)],
                       device="cpu")
    reset_osc_pvars()
    yield jworld, tworld
    trt._reset_for_tests()
    tvar.VARS.unset("runtime_virtual_ranks")


class Side:
    def __init__(self, name, world):
        jax = name == "jax"
        self.name, self.world = name, world
        self.osc = josc if jax else tosc
        self.ops = jops if jax else tops
        self.plan = jplan if jax else tplan
        self.pvar = jpvar if jax else tpvar
        self.var = jvar if jax else tvar
        self.Op = JOp if jax else TOp
        self.PendingOp = JPendingOp if jax else TPendingOp

    def pv(self, name):
        p = self.pvar.PVARS.lookup(name)
        assert p is not None, name
        return p.read()

    def interpreted(self, fn):
        """Run fn with access plans off (the interpreted twin)."""
        self.var.set_value("osc_compiled", 0)
        try:
            return fn()
        finally:
            self.var.VARS.unset("osc_compiled")


def obs(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if hasattr(v, "dtype") and hasattr(v, "shape"):
        return np.asarray(v)
    if isinstance(v, dict):
        return {k: obs(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [obs(x) for x in v]
    return v


def same(a, b):
    a, b = obs(a), obs(b)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    return a == b


def both(worlds, script):
    j = script(Side("jax", worlds[0]))
    t = script(Side("torch", worlds[1]))
    assert same(j, t), (obs(j), obs(t))
    return j, t


def delta(after, before):
    if isinstance(after, dict):
        return {k: after[k] - before[k] for k in after}
    return after - before


# ---------------------------------------------------------------------------
# 1. parity matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("sync", ["fence", "lock", "pscw"])
def test_epoch_matrix_bitwise(worlds, dtype, sync):
    def epoch(S, w, pay, acc):
        if sync == "fence":
            w.fence()
        elif sync == "lock":
            w.lock(1, S.osc.LOCK_EXCLUSIVE)
        else:
            w.post(S.world.group)
            w.start(S.world.group)
        w.put(pay, target=1)
        w.accumulate(acc, target=1, op=S.ops.SUM)
        g = w.get(target=1)
        ga = w.get_accumulate(acc, target=1, op=S.ops.MAX)
        if sync == "fence":
            w.fence_end()
        elif sync == "lock":
            w.unlock(1)
        else:
            w.complete()
            w.wait()
        return [g.value, ga.value, w.read()]

    def script(S):
        rng = np.random.default_rng(7)
        data = [((rng.standard_normal(4) * 9).astype(dtype),
                 (rng.standard_normal(4) * 9).astype(dtype))
                for _ in range(3)]

        def run(w):
            return [epoch(S, w, p, a) for p, a in data]

        wi = S.osc.win_allocate(S.world, (4,), dtype)
        wc = S.osc.win_allocate(S.world, (4,), dtype)
        want = S.interpreted(lambda: run(wi))
        h0 = S.pv("osc_plan_cache_hits")
        got = run(wc)
        h1 = S.pv("osc_plan_cache_hits")
        wi.free()
        wc.free()
        assert same(got, want)
        # epoch 1 captures (observe 0), 2..3 replay (observe 1)
        return [got, delta(h1, h0)]

    j, t = both(worlds, script)
    assert obs(t[1])["sum"] == 2


def test_indexed_cas_and_fetch_parity(worlds):
    def script(S):
        def run(w):
            w.fence()
            w.put(np.arange(6, dtype=np.float32), target=1)
            w.fence_end()
            w.lock(1, S.osc.LOCK_EXCLUSIVE)
            old = w.compare_and_swap(np.float32(99.0), np.float32(3.0),
                                     target=1, index=3)
            fetched = w.fetch_and_op(np.float32(10.0), target=1,
                                     op=S.ops.SUM, index=0)
            w.unlock(1)
            return [old.value, fetched.value, w.read()]

        wi = S.osc.win_allocate(S.world, (6,), np.float32)
        wc = S.osc.win_allocate(S.world, (6,), np.float32)
        want = S.interpreted(lambda: run(wi))
        got = run(wc)    # capture
        got2 = run(wc)   # replay
        want2 = S.interpreted(lambda: run(wi))
        wi.free()
        wc.free()
        assert same(got + got2, want + want2)
        return got + got2

    both(worlds, script)


# ---------------------------------------------------------------------------
# 2. steady state: one plan, one built close
# ---------------------------------------------------------------------------

def test_ten_epochs_one_program(worlds):
    def script(S):
        w = S.osc.win_allocate(S.world, (4,), np.float32)
        S.var.set_value("osc_plan_max_ops", 128)  # pin the generation
        try:
            pay = np.full(4, 2.0, np.float32)
            h0 = S.pv("osc_plan_cache_hits")
            p0 = S.pv("osc_plan_programs")
            f0 = S.pv("osc_plans_frozen")
            for _ in range(10):
                w.lock(1, S.osc.LOCK_EXCLUSIVE)
                w.put(pay, target=1)
                w.accumulate(pay, target=1, op=S.ops.SUM)
                w.unlock(1)
            out = [delta(S.pv("osc_plan_cache_hits"), h0),
                   S.pv("osc_plan_programs") - p0,
                   S.pv("osc_plans_frozen") - f0,
                   len(w._access_plans), w.read()]
        finally:
            S.var.VARS.unset("osc_plan_max_ops")
        w.free()
        return out

    _, t = both(worlds, script)
    assert (t[0]["count"], t[0]["sum"]) == (10, 9)
    assert t[1:4] == [1, 1, 1]


def test_orchestration_timer_feeds_both_paths(worlds):
    def script(S):
        w = S.osc.win_allocate(S.world, (4,), np.float32)

        def one():
            w.fence()
            w.put(np.ones(4, np.float32), target=0)
            w.fence_end()

        o0 = S.pv("osc_orchestration_seconds")
        S.interpreted(one)
        o1 = S.pv("osc_orchestration_seconds")
        one()  # capture
        one()  # replay
        o2 = S.pv("osc_orchestration_seconds")
        w.free()
        return [o1 > o0, o2 > o1]

    j, _ = both(worlds, script)
    assert j == [True, True]


def test_oversized_epoch_stays_interpreted(worlds):
    def script(S):
        w = S.osc.win_allocate(S.world, (4,), np.float32)
        S.var.set_value("osc_plan_max_ops", 2)
        try:
            h0 = S.pv("osc_plan_cache_hits")
            w.fence()
            for k in range(3):
                w.put(np.full(4, float(k), np.float32), target=1)
            w.fence_end()
            h1 = S.pv("osc_plan_cache_hits")
            out = [h1["count"] == h0["count"], len(w._access_plans),
                   w.read()]
        finally:
            S.var.VARS.unset("osc_plan_max_ops")
        w.free()
        return out

    j, _ = both(worlds, script)
    assert j[:2] == [True, 0]


# ---------------------------------------------------------------------------
# 3. lifecycle: generation, divergence, eviction
# ---------------------------------------------------------------------------

def _one(S, w, v=5.0):
    w.lock(1, S.osc.LOCK_EXCLUSIVE)
    w.put(np.full(4, v, np.float32), target=1)
    w.unlock(1)


def test_cvar_write_replans(worlds):
    def script(S):
        w = S.osc.win_allocate(S.world, (4,), np.float32)
        _one(S, w)  # capture + freeze
        _one(S, w)  # replay
        (sig, old_plan), = w._access_plans.items()
        # ANY cvar write bumps the registry generation: the frozen plan
        # is stale at the next close
        S.var.set_value("wire_pipeline_depth", 6)
        try:
            h0 = S.pv("osc_plan_cache_hits")
            _one(S, w, 6.0)  # re-capture under the new generation
            h1 = S.pv("osc_plan_cache_hits")
            new_plan = w._access_plans[sig]
            _one(S, w, 7.0)  # and replays resume
            h2 = S.pv("osc_plan_cache_hits")
            out = [delta(h1, h0), new_plan is not old_plan,
                   new_plan.gen > old_plan.gen, delta(h2, h1), w.read()]
        finally:
            S.var.VARS.unset("wire_pipeline_depth")
        w.free()
        return out

    j, _ = both(worlds, script)
    assert (j[0]["count"], j[0]["sum"], j[3]["sum"]) == (1, 0, 1)
    assert j[1] and j[2]


def test_divergence_drops_plan_loudly(worlds):
    def script(S):
        w = S.osc.win_allocate(S.world, (4,), np.float32)
        _one(S, w)
        _one(S, w)  # replay: the plan holds a built close
        (sig, plan), = w._access_plans.items()
        built = plan.prog is not None

        def boom(*a, **k):
            raise RuntimeError("synthetic divergence")

        plan.prog = boom
        _one(S, w, 3.0)  # must fall back interpreted, not raise
        out = [built, w.read(), sig not in w._access_plans]
        _one(S, w, 4.0)  # re-records a fresh plan
        fresh = w._access_plans[sig]
        h0 = S.pv("osc_plan_cache_hits")
        _one(S, w, 5.0)
        out += [fresh is not plan,
                S.pv("osc_plan_cache_hits")["sum"] - h0["sum"], w.read()]
        w.free()
        return out

    j, _ = both(worlds, script)
    assert j[0] and j[2] and j[3] and j[4] == 1


def test_window_free_evicts_plans(worlds):
    def script(S):
        w = S.osc.win_allocate(S.world, (4,), np.float32)
        _one(S, w)
        had = bool(w._access_plans)
        w.free()
        return [had, bool(w._access_plans)]

    j, _ = both(worlds, script)
    assert j == [True, False]


def test_unhashable_payload_is_skipped(worlds):
    def script(S):
        p = S.PendingOp("put", 0, data=[1.0, "x"], op=S.ops.REPLACE)
        return [S.plan.epoch_signature([p])]

    j, _ = both(worlds, script)
    assert j == [None]


def test_same_named_user_op_gets_its_own_plan(worlds):
    """Op keying is by OBJECT, not name: a user op named "sum" must not
    reuse SUM's frozen plan."""
    def script(S):
        clobber = S.Op("sum", lambda a, b: a * 0 + 99.0, commutative=True)
        w = S.osc.win_allocate(S.world, (4,), np.float32)

        def run(op):
            w.fence()
            w.accumulate(np.full(4, 2.0, np.float32), target=1, op=op)
            w.fence_end()
            return w.read()

        out = [run(S.ops.SUM), run(S.ops.SUM), run(clobber),
               len(w._access_plans), run(S.ops.SUM)]
        w.free()
        return out

    j, _ = both(worlds, script)
    assert j[3] == 2
    np.testing.assert_array_equal(obs(j[2])[1], np.full(4, 99.0))
    np.testing.assert_array_equal(obs(j[4])[1], np.full(4, 101.0))


def test_steady_closes_hit_registry_zero_times(worlds, monkeypatch):
    def script(S):
        w = S.osc.win_allocate(S.world, (4,), np.float32)
        pay = np.full(4, 1.0, np.float32)

        def one():
            w.lock(1, S.osc.LOCK_EXCLUSIVE)
            w.put(pay, target=1)
            w.unlock(1)

        for _ in range(3):
            one()  # warm: conf cached, plan frozen + replaying
        calls = []
        real_get = S.var.get
        with monkeypatch.context() as m:
            m.setattr(S.var, "get",
                      lambda *a, **k: calls.append(a) or real_get(*a, **k))
            for _ in range(5):
                one()
        w.free()
        return [calls]

    j, _ = both(worlds, script)
    assert j == [[]]


def test_cache_stats_shape(worlds):
    assert set(tplan.cache_stats()) == set(jplan.cache_stats())
    st = tplan.cache_stats()
    assert st["batch_templates"] == 0 and st["hits"] <= st["fires"]


def test_signature_matches_jax_fields(worlds):
    """The signature's per-op fields are the reference's (its spanning
    ``status_rank`` aside): kind, target, payload shape, op object,
    compare, index, request flag."""
    def script(S):
        from ompi_release_tpu.request.request import Request as JR
        from ompi_release_tpu_torch.request.request import Request as TR

        R = JR if S.plan is jplan else TR
        pay = np.arange(4, dtype=np.float32)
        ops_ = [S.PendingOp("put", 1, data=pay, op=S.ops.REPLACE),
                S.PendingOp("acc", 2, data=pay, op=S.ops.SUM, index=3),
                S.PendingOp("get", 1, request=R()),
                S.PendingOp("cas", 0, data=pay, compare=pay,
                            request=R(), index=2)]
        sig = S.plan.epoch_signature(ops_)
        return [[(e[0], e[1], e[2] and e[2][:2],
                  e[3][1].name if e[3] else None, e[4] and e[4][:2],
                  e[5], e[6]) for e in sig]]

    both(worlds, script)
