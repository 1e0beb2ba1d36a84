"""Frozen wire plans and the spanning half of ``coll/nbc`` in the port,
held against ``tests/test_compiled_plan.py`` (``TestWirePlanReplay``,
``TestCompiledPlanJob``) and ``tests/test_nbc.py`` (``TestNbcJobs``).

- ``SpanningPlanState`` on a stand-in hier module: the first fire
  records, later fires replay through planned sends with the plan-time
  timeout; a diverged replay is the typed error and drops the plan; the
  ``wire_overlap_exchange`` opt-out stays interpreted; a cvar write
  re-plans at the next fire. The same fake schedule through the JAX
  package's ``SpanningPlanState`` records the same round structure.
- ``WireRouter._stripe`` pulls every stream to its end in depth-sized
  round-robin bursts.
- 2-process port jobs: blocking fires and persistent starts replay the
  frozen plan bitwise (``coll_compiled_cache_hits`` counts the replays,
  ``coll_wire_rounds_frozen`` the frozen rounds, ``cache_stats``'
  ``spanning_plans`` the states), a cvar write re-plans once; the
  spanning nonblocking story — dispatch only queues, a blocking call
  drains earlier i-ops in posting order, a test()-only loop completes,
  six i-families match their blocking twins bitwise, a persistent
  request follows its buffer, and two i-allreduces on disjoint spanning
  comms complete under the progress thread with hidden time.
"""

import os
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest

from ompi_release_tpu.coll import plan as jplan
from ompi_release_tpu_torch.coll import plan
from ompi_release_tpu_torch.mca import pvar
from ompi_release_tpu_torch.mca import var as mca_var
from ompi_release_tpu_torch.runtime.state import JobState
from ompi_release_tpu_torch.runtime.wire import WireRouter
from ompi_release_tpu_torch.tools.tpurun import Job
from ompi_release_tpu_torch.utils.errors import ErrorCode, MPIError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pv(name):
    p = pvar.PVARS.lookup(name)
    return p.read() if p is not None else 0


class _FakeInner:
    def __init__(self):
        self.rounds = 0

    def exchange(self, sends, recvs):
        self.rounds += 1
        return {p: [np.zeros(4, np.float32)] * int(c)
                for p, c in recvs.items() if int(c) > 0}


class _FakeModule:
    my_pidx = 0
    _round = 0

    def __init__(self, comm):
        self.comm = comm
        self._xchg = _FakeInner()
        self.planned_rounds = []
        self.reap_timeouts = []

    def _send_all_planned(self, rnd, sends):
        self.planned_rounds.append(rnd)

    def _reap(self, pending, on_arrival, timeout_ms=None, record=True):
        self.reap_timeouts.append(timeout_ms)
        for p, c in pending.items():
            for _ in range(c):
                on_arrival(p, np.zeros(4, np.float32))


def _fake_comm(cid):
    comm = SimpleNamespace(cid=cid, name=f"fake{cid}",
                           runtime=SimpleNamespace(wire=None))
    comm._hier_module = _FakeModule(comm)
    return comm


def _schedule(m, payload):
    """A two-round fixed schedule driven through m._xchg."""
    got1 = m._xchg.exchange({1: [payload]}, {1: 1})
    got2 = m._xchg.exchange({2: [payload, payload]}, {2: 2})
    return got1[1][0] + got2[2][0]


def _manual_plan(mod, recorded, gen, cid):
    rounds = [mod.WireRound(meta, rec, tuple(
        (p, tuple(None for _ in arrs)) for p, arrs in meta),
        tag=0, depth=1) for meta, rec in recorded]
    return mod.WirePlan(gen, cid, rounds, 60_000)


@pytest.fixture
def manual_freeze(monkeypatch):
    monkeypatch.setattr(
        plan, "freeze_wire_plan",
        lambda c, rec, gen, metas=None: _manual_plan(plan, rec, gen,
                                                     c.cid))


class TestWirePlanReplay:
    def test_record_then_replay_uses_planned_sends(self, manual_freeze):
        comm = _fake_comm(900)
        m = comm._hier_module
        state = plan.SpanningPlanState(comm, "allreduce")
        payload = np.ones(4, np.float32)
        h0 = _pv("coll_compiled_cache_hits")
        state.run(lambda: _schedule(m, payload), (), {})  # records
        assert state.plan is not None and len(state.plan.rounds) == 2
        assert m._xchg.rounds == 2 and not m.planned_rounds
        assert state.last == "interpreted"
        # the stand-in module has no router: the native compile
        # withdrew and said why
        assert state.native is None and "nativewire" in state.why
        state.run(lambda: _schedule(m, payload), (), {})  # replays
        assert m._xchg.rounds == 2, "replay used the interpreted adapter"
        assert len(m.planned_rounds) == 2 and state.last == "planned"
        # replay waits are bounded by the PLAN-TIME timeout snapshot
        assert m.reap_timeouts == [60_000, 60_000]
        h1 = _pv("coll_compiled_cache_hits")
        assert h1["sum"] - h0["sum"] == 1
        assert h1["count"] - h0["count"] == 2

    def test_recorded_rounds_match_the_jax_package(self, monkeypatch):
        """The same schedule recorded by both packages' plan states
        freezes the same round structure."""
        frozen = {}
        for mod in (plan, jplan):
            monkeypatch.setattr(
                mod, "freeze_wire_plan",
                lambda c, rec, gen, metas=None, _m=mod: _manual_plan(
                    _m, rec, gen, c.cid))
            comm = _fake_comm(904)
            m = comm._hier_module
            monkeypatch.setattr(m, "router", None, raising=False)
            st = mod.SpanningPlanState(comm, "allreduce")
            st.run(lambda: _schedule(m, np.ones(4, np.float32)), (), {})
            frozen[mod] = [(r.sends_meta, r.recvs_t)
                           for r in st.plan.rounds]
        assert frozen[plan] == frozen[jplan]

    def test_divergence_is_a_loud_typed_error(self, manual_freeze):
        comm = _fake_comm(901)
        m = comm._hier_module
        state = plan.SpanningPlanState(comm, "allreduce")
        state.run(lambda: _schedule(m, np.ones(4, np.float32)), (), {})
        with pytest.raises(MPIError) as ei:
            state.run(lambda: _schedule(m, np.ones(5, np.float32)),
                      (), {})
        assert ei.value.code == ErrorCode.ERR_INTERN
        assert "diverged" in str(ei.value)
        # the raise DROPS the stale plan: the next fire re-records
        assert state.plan is None
        state.run(lambda: _schedule(m, np.ones(5, np.float32)), (), {})
        assert state.plan.rounds[0].sends_meta[0][1][0][0] == (5,)

    def test_overlap_opt_out_stays_interpreted(self, manual_freeze):
        comm = _fake_comm(903)
        m = comm._hier_module
        state = plan.SpanningPlanState(comm, "allreduce")
        pay = np.ones(4, np.float32)
        mca_var.set_value("wire_overlap_exchange", False)
        try:
            state.run(lambda: _schedule(m, pay), (), {})
            state.run(lambda: _schedule(m, pay), (), {})
            assert state.plan is None
            assert m._xchg.rounds == 4 and not m.planned_rounds
        finally:
            mca_var.VARS.unset("wire_overlap_exchange")
        state.run(lambda: _schedule(m, pay), (), {})  # re-enabled
        assert state.plan is not None

    def test_cvar_write_takes_effect_at_next_plan(self, manual_freeze):
        comm = _fake_comm(902)
        m = comm._hier_module
        state = plan.SpanningPlanState(comm, "allreduce")
        pay = np.ones(4, np.float32)
        state.run(lambda: _schedule(m, pay), (), {})
        frozen = state.plan
        state.run(lambda: _schedule(m, pay), (), {})  # replay
        assert state.plan is frozen
        mca_var.set_value("wire_pipeline_depth", 9)  # generation bump
        try:
            state.run(lambda: _schedule(m, pay), (), {})
            assert state.plan is not frozen
            assert m._xchg.rounds == 4  # 2 recorded + 2 re-recorded
        finally:
            mca_var.VARS.unset("wire_pipeline_depth")

    def test_stripe_round_robins_depth_bursts(self):
        """Every frame of every stream is pulled once, in depth-sized
        round-robin bursts, each stream run to its end (its epilogue,
        the byte accounting, included) — the same discipline as the
        JAX package's striper without QoS counts."""
        log, ends = [], []

        def gen(label, n):
            for i in range(n):
                log.append((label, i))
                yield
            ends.append(label)

        WireRouter._stripe([gen("a", 3), gen("b", 1), gen("c", 5)], 2)
        assert sorted(ends) == ["a", "b", "c"]
        assert log == [("a", 0), ("a", 1), ("b", 0), ("c", 0), ("c", 1),
                       ("a", 2), ("c", 2), ("c", 3), ("c", 4)]


# ---------------------------------------------------------------------------
# 2-process jobs of the port
# ---------------------------------------------------------------------------

APP_PRELUDE = textwrap.dedent("""
    import os, sys, time
    sys.path.insert(0, %r)
    import numpy as np
    import torch
    import ompi_release_tpu_torch as mpi
    from ompi_release_tpu_torch.coll import plan as cplan
    from ompi_release_tpu_torch.mca import pvar, var as mca_var
    from ompi_release_tpu_torch.request import request as req_mod
    from ompi_release_tpu_torch.runtime import progress
    from ompi_release_tpu_torch.runtime.runtime import Runtime

    def _pv(name):
        p = pvar.PVARS.lookup(name)
        return p.read() if p is not None else 0.0

    world = mpi.init(cli_args=["--mca", "runtime_virtual_ranks", "2"],
                     device="cpu")
    rt = Runtime.current()
    me = rt.bootstrap["process_index"]
    off = rt.local_rank_offset
    n = world.size
""" % REPO)


def _run(tmp_path, capfd, body, n=2, timeout=180):
    app = tmp_path / "app.py"
    app.write_text(APP_PRELUDE + textwrap.dedent(body))
    job = Job(n, [sys.executable, str(app)], [], heartbeat_s=0.5,
              miss_limit=8)
    rc = job.run(timeout_s=timeout)
    out = capfd.readouterr()
    assert rc == 0, out.out + out.err
    assert job.job_state.visited(JobState.TERMINATED)
    return out.out


class TestCompiledPlanJob:
    def test_spanning_persistent_replays_frozen_wire_plan(self, tmp_path,
                                                          capfd):
        out = _run(tmp_path, capfd, """
            x = np.stack([np.arange(512, dtype=np.float32) * (off + i + 1)
                          for i in range(2)])
            want = sum(np.arange(512, dtype=np.float32) * (r + 1)
                       for r in range(n))
            first = world.allreduce(x).numpy()  # record + freeze
            np.testing.assert_array_equal(first[0], want)
            assert _pv("coll_wire_rounds_frozen") >= 1
            assert cplan.cache_stats()["spanning_plans"] >= 1
            st0 = _pv("coll_compiled_cache_hits")
            for _ in range(3):
                got = world.allreduce(x).numpy()  # replay
                assert got.tobytes() == first.tobytes()
            # every fire is a hit: the spanning plan's replay and its
            # shadow comm's frozen local collective (one each)
            st1 = _pv("coll_compiled_cache_hits")
            assert st1["sum"] - st0["sum"] == 6, (st0, st1)
            assert st1["count"] - st0["count"] == 6, (st0, st1)

            pr = world.allreduce_init(x)
            st0 = _pv("coll_compiled_cache_hits")
            for k in range(3):
                pr.start(); pr.wait()
                assert pr.value.numpy().tobytes() == first.tobytes()
                # same (cid, signature) as the blocking fires: every
                # start replays the already-frozen plan
            st1 = _pv("coll_compiled_cache_hits")
            assert st1["sum"] - st0["sum"] == 6, (st0, st1)
            assert st1["count"] - st0["count"] == 6, (st0, st1)

            # a cvar write re-plans at the NEXT fire (one recording
            # run, then replays resume) — never mid-schedule
            sts = [v for k, v in cplan._span_states.items()
                   if k[0] == world.cid and k[1][0] == "allreduce"]
            assert len(sts) == 1, sts
            st = sts[0]
            p0 = st.plan
            assert st.last in ("native", "planned") and p0 is not None
            mca_var.set_value("wire_pipeline_depth", 2)
            got = world.allreduce(x).numpy()
            assert got.tobytes() == first.tobytes()
            assert st.last == "interpreted" and st.plan is not p0
            got = world.allreduce(x).numpy()
            assert got.tobytes() == first.tobytes()
            assert st.last in ("native", "planned"), (st.last, st.why)
            # plans of a freed comm go with it
            d = world.dup(name="plan_free")
            d.allreduce(x)
            cid = d.cid
            assert any(k[0] == cid for k in cplan._span_states)
            d.free()
            assert not any(k[0] == cid for k in cplan._span_states)
            print("PLAN-JOB-OK", flush=True)
            mpi.finalize()
        """)
        assert out.count("PLAN-JOB-OK") == 2


class TestNbcJobs:
    def test_nbc_spanning_job(self, tmp_path, capfd):
        out = _run(tmp_path, capfd, """
            x = np.stack([np.arange(16, dtype=np.int32) * (off + i + 1)
                          for i in range(2)])
            want = sum(np.arange(16, dtype=np.int32) * (r + 1)
                       for r in range(n))

            # dispatch only queues the schedule (polling mode): it runs
            # at a wait, a later blocking call, or a test()
            posted = _pv("nbc_ops_posted")
            r1 = world.iallreduce(x)
            assert _pv("nbc_ops_posted") == posted + 1
            assert r1._sched_op.state == progress.QUEUED
            # posting order: the blocking barrier drains r1 FIRST
            world.barrier()
            assert r1.test()[0], "barrier did not drain the iallreduce"
            np.testing.assert_array_equal(r1.value.numpy()[0], want)

            # a test()-only polling loop completes
            r2 = world.iallreduce(x)
            deadline = time.time() + 60
            while not r2.test()[0]:
                assert time.time() < deadline, "test() never completed"
                time.sleep(0.005)
            np.testing.assert_array_equal(r2.value.numpy()[0], want)

            # six families, blocking-vs-nonblocking bitwise parity
            xb = np.stack([np.arange(8, dtype=np.int32) + 10 * (off + i)
                           for i in range(2)])
            xa2a = np.stack([np.arange(n, dtype=np.int32)
                             + 100 * (off + i) for i in range(2)])
            xrs = np.stack([np.full(n * 2, off + i + 1, np.int32)
                            for i in range(2)])
            counts = [2] * n
            exp = {
                "bcast": world.bcast(xb, root=3).numpy(),
                "allgather": world.allgather(xb).numpy(),
                "alltoall": world.alltoall(xa2a).numpy(),
                "rs": [a.numpy() for a in
                       world.reduce_scatter(xrs, counts)],
            }
            reqs = [world.iallreduce(x), world.ibcast(xb, root=3),
                    world.iallgather(xb),
                    world.ireduce_scatter(xrs, counts),
                    world.ialltoall(xa2a), world.ibarrier()]
            req_mod.wait_all(reqs)
            np.testing.assert_array_equal(reqs[0].value.numpy()[0], want)
            assert reqs[1].value.numpy().tobytes() == \\
                exp["bcast"].tobytes()
            assert reqs[2].value.numpy().tobytes() == \\
                exp["allgather"].tobytes()
            for a, b in zip(reqs[3].value, exp["rs"]):
                assert a.numpy().tobytes() == b.tobytes()
            assert reqs[4].value.numpy().tobytes() == \\
                exp["alltoall"].tobytes()

            # persistent: plan once, fire twice, buffer reuse
            buf = torch.from_numpy(x.copy())
            pr = world.allreduce_init(buf)
            assert pr.test() == (True, None)
            pr.start(); pr.wait()
            np.testing.assert_array_equal(pr.value.numpy()[0], want)
            buf.mul_(2)
            pr.start(); pr.wait()
            np.testing.assert_array_equal(pr.value.numpy()[0], want * 2)
            assert _pv("nbc_persistent_starts") >= 2

            # disjoint spanning comms under the progress thread: both
            # complete with NO wait from the caller
            A = world.create(world.group.incl([0, 2]), name="A")
            B = world.create(world.group.incl([1, 3]), name="B")
            assert A.spans_processes and B.spans_processes
            mca_var.set_value("progress_thread", True)
            xa = np.ones((1, 2048), np.float32) * (me + 1)
            h0 = _pv("nbc_hidden_seconds")
            ra = A.iallreduce(xa)
            rb = B.iallreduce(xa)
            deadline = time.time() + 60
            while not (ra.test()[0] and rb.test()[0]):
                assert time.time() < deadline, "engine never ran them"
                time.sleep(0.01)
            np.testing.assert_array_equal(ra.value.numpy()[0],
                                          np.full(2048, 3.0, np.float32))
            np.testing.assert_array_equal(rb.value.numpy()[0],
                                          np.full(2048, 3.0, np.float32))
            assert _pv("nbc_hidden_seconds") > h0
            mca_var.VARS.unset("progress_thread")
            world.barrier()
            print(f"NBC-JOB-OK {me}", flush=True)
            mpi.finalize()
        """)
        for me in (0, 1):
            assert f"NBC-JOB-OK {me}" in out
