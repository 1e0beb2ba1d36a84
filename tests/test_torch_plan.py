"""Frozen plans of the PyTorch port (``coll/plan.py``, in-process half)
held against the JAX package.

The in-process cases of ``tests/test_compiled_plan.py`` (lines 71-110,
437-588 and 881) run one script on both packages and compare what they
observe: signatures (stable across identical calls, distinct across
shape/dtype/root/op OBJECT, None for ragged and pair-op calls, scalar
sequences plannable), the ``coll_compiled_cache_hits`` series of
steady-state blocking fires, of a persistent request fired ten times
under the progress thread (one capturing fire, then hits; one cached
body), an MCA write re-capturing at the next fire (CHANGES PR 13's rule),
two same-named ops kept apart, the cache cleared on free and the
``cache_stats`` shape. Every frozen fire is BITWISE the interpreted
(``coll_compiled=false``) leg. On the CPU the frozen plan is the cached
body itself; the CUDA-graph leg runs on the card (``chip_smoke.py``).
The whole-tree pass (``test_compiled_whole_tree_pass``) waits for the
port of ``parallel/tree.py``.
"""

import numpy as np
import pytest
import torch

import ompi_release_tpu as jmpi
from ompi_release_tpu import ops as jops
from ompi_release_tpu.coll import plan as jplan
from ompi_release_tpu.mca import pvar as jpvar
from ompi_release_tpu.mca import var as jvar
import ompi_release_tpu_torch as tmpi
from ompi_release_tpu_torch import ops as tops
from ompi_release_tpu_torch.coll import driver as tdriver
from ompi_release_tpu_torch.coll import plan as tplan
from ompi_release_tpu_torch.mca import pvar as tpvar
from ompi_release_tpu_torch.mca import var as tvar
from ompi_release_tpu_torch.runtime import runtime as trt

N = 8


@pytest.fixture(scope="module")
def worlds():
    jworld = jmpi.init()
    trt._reset_for_tests()
    tworld = tmpi.init(cli_args=["--mca", "runtime_virtual_ranks", str(N)],
                       device="cpu")
    yield jworld, tworld
    trt._reset_for_tests()
    tvar.VARS.unset("runtime_virtual_ranks")


SIDES = {
    "jax": dict(plan=jplan, pvar=jpvar, var=jvar, ops=jops),
    "torch": dict(plan=tplan, pvar=tpvar, var=tvar, ops=tops),
}


def _pv(side, name):
    p = SIDES[side]["pvar"].PVARS.lookup(name)
    assert p is not None, name
    return p.read()


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _both(worlds, script):
    """Run ``script(side, world)`` on both packages; returns the two
    traces (JAX's first)."""
    jw, tw = worlds
    return script("jax", jw), script("torch", tw)


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------

def _sigs(side):
    plan, ops = SIDES[side]["plan"], SIDES[side]["ops"]
    if side == "torch":
        arr = lambda shape, dt: torch.zeros(shape, dtype=dt)  # noqa: E731
        f32, i32 = torch.float32, torch.int32
    else:
        arr = lambda shape, dt: np.zeros(shape, dt)  # noqa: E731
        f32, i32 = np.float32, np.int32
    a, b = arr((8, 16), f32), arr((8, 16), f32)
    s = plan.signature_of
    base = s("bcast", (a, 0), {})
    return [
        s("allreduce", (a, ops.SUM), {}) == s("allreduce", (b, ops.SUM), {}),
        s("allreduce", (a, ops.SUM), {}) is not None,
        base != s("bcast", (a, 1), {}),
        base != s("bcast", (arr((8, 17), f32), 0), {}),
        base != s("bcast", (arr((8, 16), i32), 0), {}),
        s("allreduce", (a, ops.SUM), {}) != s("allreduce", (a, ops.MAX), {}),
        s("allgatherv", ([arr((3,), f32)],), {}) is None,
        s("allreduce", ((a, arr((8, 16), i32)), ops.MINLOC), {}) is None,
        s("reduce_scatter", (a, [2] * 8, ops.SUM), {}) is not None,
        s("reduce_scatter", (a, [2] * 8, ops.SUM), {})
        != s("reduce_scatter", (a, [4] * 4, ops.SUM), {}),
        s("bcast", (a,), {"root": 3}) != s("bcast", (a,), {"root": 2}),
        s("bcast", (a,), {"root": object()}) is None,
    ]


def test_signatures_match_jax():
    j, t = _sigs("jax"), _sigs("torch")
    assert t == j
    assert all(t)


def test_arg_desc_of_a_tensor():
    d = tplan.arg_desc(torch.zeros(8, 4, dtype=torch.bfloat16))
    assert d == ("arr", (8, 4), "torch.bfloat16")
    assert tplan.arg_desc(tops.SUM) == ("op", tops.SUM)


# ---------------------------------------------------------------------------
# in-process plans
# ---------------------------------------------------------------------------

def _steady(side, world):
    x = np.arange(N * 32, dtype=np.float32).reshape(N, 32)
    comm = world.dup(name="plan_blk")
    try:
        first = _np(comm.allreduce(x))  # capture
        h0 = _pv(side, "coll_compiled_cache_hits")
        c0 = _pv(side, "coll_programs_compiled")
        same = [np.array_equal(_np(comm.allreduce(x)), first)
                for _ in range(3)]
        h1 = _pv(side, "coll_compiled_cache_hits")
        return [same, h1["sum"] - h0["sum"], h1["count"] - h0["count"],
                _pv(side, "coll_programs_compiled") - c0]
    finally:
        comm.free()


def test_steady_state_blocking_fires_frozen_plan(worlds):
    j, t = _both(worlds, _steady)
    assert t == j == [[True] * 3, 3, 3, 0]


def _persistent_ten(side, world):
    var = SIDES[side]["var"]
    base = np.arange(N * 64, dtype=np.float32).reshape(N, 64)
    var.set_value("coll_compiled", 0)
    try:
        refs = [_np(world.allreduce(base + k)) for k in range(10)]
    finally:
        var.VARS.unset("coll_compiled")
    var.set_value("progress_thread", 1)
    comm = world.dup(name="plan_pers")
    try:
        buf = base.copy() if side == "jax" else torch.from_numpy(base.copy())
        req = comm.allreduce_init(buf)
        h0 = _pv(side, "coll_compiled_cache_hits")
        c0 = _pv(side, "coll_programs_compiled")
        bitwise = []
        for k in range(10):
            req.start()
            req.wait()
            bitwise.append(np.array_equal(_np(req.value), refs[k]))
            buf += 1  # start() must read the CURRENT bytes
        h1 = _pv(side, "coll_compiled_cache_hits")
        return [bitwise, h1["count"] - h0["count"], h1["sum"] - h0["sum"],
                _pv(side, "coll_programs_compiled") - c0, refs]
    finally:
        var.VARS.unset("progress_thread")
        comm.free()


def test_persistent_ten_fires_one_capture(worlds):
    """A persistent allreduce fired ten times with its bound buffer
    changed in place: one capturing fire, nine hits, one cached body,
    bitwise the interpreted leg on every fire, progress thread on — and
    the interpreted references equal JAX's."""
    j, t = _both(worlds, _persistent_ten)
    assert t[:4] == j[:4] == [[True] * 10, 10, 9, 1]
    for a, b in zip(t[4], j[4]):
        np.testing.assert_allclose(a, b, rtol=1e-6)  # fused vs psum


def _invalidate(side, world):
    var = SIDES[side]["var"]
    x = np.ones((N, 16), np.float32)
    comm = world.dup(name="plan_inval")
    try:
        comm.allreduce(x)  # capture
        h0 = _pv(side, "coll_compiled_cache_hits")
        comm.allreduce(x)  # hit
        var.set_value("coll_pipeline_segsize", 4096)
        try:
            comm.allreduce(x)  # generation moved: re-capture
            comm.allreduce(x)  # hit on the new plan
        finally:
            var.VARS.unset("coll_pipeline_segsize")
        h1 = _pv(side, "coll_compiled_cache_hits")
        return [h1["count"] - h0["count"], h1["sum"] - h0["sum"]]
    finally:
        comm.free()


def test_cvar_write_invalidates_plan(worlds):
    j, t = _both(worlds, _invalidate)
    assert t == j == [3, 2]


def test_cvar_write_recaptures_with_the_new_value(worlds):
    """After a tuned cvar write the next fire follows the new value: a
    forced algorithm's frozen body replaces the old one (port only: the
    JAX twin's program objects are opaque)."""
    _, tw = worlds
    tvar.set_value("coll", "tuned")
    try:
        comm = tw.dup(name="plan_follow")
    finally:
        tvar.VARS.unset("coll")
    x = torch.randn(N, 4096)
    try:
        comm.allreduce(x)
        comm.allreduce(x)
        key = [k for k in tplan._device_plans if k[0] == comm.cid][0]
        before = tplan._device_plans[key]["frozen"].body
        tvar.set_value("coll_tuned_allreduce_algorithm", "basic_linear")
        try:
            got = comm.allreduce(x)
            after = tplan._device_plans[key]["frozen"].body
            assert after is not before
            assert ("tuned", "allreduce", "basic_linear", tops.SUM) in \
                comm._coll_programs
            tvar.set_value("coll_compiled", False)
            want = comm.allreduce(x)
        finally:
            tvar.VARS.unset("coll_compiled")
            tvar.VARS.unset("coll_tuned_allreduce_algorithm")
        assert torch.equal(got, want)
    finally:
        comm.free()


def _same_name(side, world):
    ops = SIDES[side]["ops"]
    if side == "torch":
        op_add = ops.Op("custom", lambda a, b: a + b, commutative=True)
        op_max = ops.Op("custom", torch.maximum, commutative=True)
    else:
        import jax.numpy as jnp

        op_add = ops.Op("custom", lambda a, b: a + b, commutative=True)
        op_max = ops.Op("custom", lambda a, b: jnp.maximum(a, b),
                        commutative=True)
    x = np.random.default_rng(7).standard_normal((N, 32)).astype(np.float32)
    comm = world.dup(name="plan_opkey")
    try:
        ra = _np(comm.allreduce(x, op=op_add))
        rb = _np(comm.allreduce(x, op=op_max))
        return [np.allclose(ra[0], x.sum(axis=0), rtol=1e-5),
                np.array_equal(rb[0], x.max(axis=0)),
                np.array_equal(_np(comm.allreduce(x, op=op_add)), ra),
                np.array_equal(_np(comm.allreduce(x, op=op_max)), rb)]
    finally:
        comm.free()


def test_same_named_ops_get_distinct_plans(worlds):
    j, t = _both(worlds, _same_name)
    assert t == j == [True] * 4


def _cleared(side, world):
    plan = SIDES[side]["plan"]
    x = np.ones((N, 8), np.float32)
    comm = world.dup(name="plan_free")
    cid = comm.cid
    comm.allreduce(x)
    before = any(k[0] == cid for k in plan._device_plans)
    comm.free()
    return [before, any(k[0] == cid for k in plan._device_plans)]


def test_plan_cache_cleared_on_comm_free(worlds):
    j, t = _both(worlds, _cleared)
    assert t == j == [True, False]


def test_cache_stats_shape():
    st, jst = tplan.cache_stats(), jplan.cache_stats()
    assert set(st) == set(jst) == {"device_plans", "spanning_plans",
                                   "fires", "hits"}
    assert st["fires"] >= st["hits"] >= 0 and st["spanning_plans"] == 0


# ---------------------------------------------------------------------------
# what the plan freezes, and what stays interpreted
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coll", ["tuned", "fused", "basic"])
@pytest.mark.parametrize("nbytes", [8, 4 << 10, 64 << 10, 4 << 20])
def test_main_path_families_freeze_bitwise(worlds, coll, nbytes):
    """The main path's families freeze on every provider (none is
    "bad"), and each frozen fire is bitwise the interpreted leg."""
    _, tw = worlds
    tvar.set_value("coll", coll)
    try:
        comm = tw.dup(name=f"plan_{coll}")
    finally:
        tvar.VARS.unset("coll")
    g = torch.Generator().manual_seed(nbytes)
    x = torch.randn(N, nbytes // 4, generator=g)
    calls = [("allreduce", (x,))]
    if coll != "basic":
        calls += [("bcast", (x, 3)), ("allgather", (x,)),
                  ("reduce_scatter_block", (x,)), ("alltoall", (x,))]
    try:
        for name, args in calls:
            if name in ("reduce_scatter_block", "alltoall") \
                    and x.shape[1] % N:
                continue
            outs = [getattr(comm, name)(*args) for _ in range(3)]
            tvar.set_value("coll_compiled", False)
            try:
                want = getattr(comm, name)(*args)
            finally:
                tvar.VARS.unset("coll_compiled")
            for o in outs:
                assert torch.equal(o, want), (coll, name, nbytes)
        assert not any("bad" in e for k, e in tplan._device_plans.items()
                       if k[0] == comm.cid)
    finally:
        comm.free()


def test_ml_families_freeze(worlds):
    _, tw = worlds
    tvar.set_value("coll", "ml")
    tvar.set_value("coll_ml_local_size", 4)
    try:
        comm = tw.dup(name="plan_ml")
    finally:
        tvar.VARS.unset("coll")
        tvar.VARS.unset("coll_ml_local_size")
    x = torch.randn(N, 64, generator=torch.Generator().manual_seed(2))
    try:
        for name, args in (("allreduce", (x,)), ("bcast", (x, 5)),
                           ("allgather", (x,)),
                           ("reduce_scatter_block", (x,)),
                           ("alltoall", (x,))):
            outs = [getattr(comm, name)(*args) for _ in range(2)]
            assert torch.equal(outs[0], outs[1]), name
        entries = [e for k, e in tplan._device_plans.items()
                   if k[0] == comm.cid]
        assert len(entries) == 5 and all("frozen" in e for e in entries)
    finally:
        comm.free()


def test_preprocessing_dispatch_stays_interpreted(worlds):
    """A collective whose result is not the runner's output (the general
    reduce_scatter slices it) fails the identity proof: its entry is
    "bad" and every fire runs the interpreted path."""
    _, tw = worlds
    comm = tw.dup(name="plan_bad")
    x = np.arange(N * 2 * N, dtype=np.float32).reshape(N, 2 * N)
    try:
        outs = [comm.reduce_scatter(x, [2] * N) for _ in range(2)]
        (e,) = [e for k, e in tplan._device_plans.items()
                if k[0] == comm.cid]
        assert "bad" in e
        for a, b in zip(*outs):
            assert torch.equal(a, b)
    finally:
        comm.free()


def test_orchestration_timer_and_capture_hooks(worlds):
    """Both legs feed ``coll_orchestration_seconds``; an armed capture
    records (body, input, output) per runner launch."""
    _, tw = worlds
    x = torch.ones(N, 8)
    t0 = tpvar.PVARS.lookup("coll_orchestration_seconds").read()
    cap = tdriver.begin_capture()
    try:
        out = tw.c_coll["allreduce"](tw, x, tops.SUM)
    finally:
        tdriver.end_capture()
    assert len(cap) == 1 and cap[0]["x"] is x and cap[0]["out"] is out
    assert callable(cap[0]["prog"]) and not cap[0]["extra"]
    tw.allreduce(x)
    assert tpvar.PVARS.lookup("coll_orchestration_seconds").read() > t0


def test_index_cache_miss_during_capture_raises_and_is_not_cached():
    """While a capture holds indices, a miss raises (never cached) and a
    hit is recorded in the holds."""
    from ompi_release_tpu_torch.coll import spmd

    hit = spmd._idx([0, 1, 2], torch.device("cpu"))
    holds = []
    spmd.hold_indices(holds)
    try:
        assert spmd._idx([0, 1, 2], torch.device("cpu")) is hit
        with pytest.raises(RuntimeError, match="capture"):
            spmd._idx([7, 7, 7, 7, 7, 7, 7, 7, 7], torch.device("cpu"))
    finally:
        spmd.hold_indices(None)
    assert holds == [hit]
    fresh = spmd._idx([7, 7, 7, 7, 7, 7, 7, 7, 7], torch.device("cpu"))
    assert fresh.tolist() == [7] * 9
