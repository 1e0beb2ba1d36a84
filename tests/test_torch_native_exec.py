"""The port's ``coll/native_exec.py`` (the C plan executor of frozen
wire plans) held against ``tests/test_native_exec.py`` and the JAX
package's functions.

- the descriptor blob is byte-identical to the JAX package's for the
  same tables and round-trips through the C parser; a garbage blob is
  refused;
- the byte-provenance matcher decomposes payloads exactly as the JAX
  package's does, and refuses foreign and too-small payloads;
- ``try_compile`` withdraws (None, the reason kept) when the cvar is
  off, the symbols are missing, a message to a co-hosted peer exceeds
  the shm ring, or anything raises;
- ``PlannedXchg`` sends the schedule's own host arrays and refuses a
  diverged round with the typed error;
- pool aliasing: a round materialized out of the reused reassembly
  pool is a copy, unchanged when the pool is overwritten;
- 2-process port jobs: the executor engages on a recursive-doubling
  allreduce and stays bitwise its interpreted twin fire after fire,
  with a result of fire k unchanged by fire k+1; a mixed fleet (one
  worker with ``coll_plan_native`` off) interoperates bitwise; a worker
  killed between native fires ends the job with a non-zero exit code
  quickly, never a hang under the abort policy (the reference's ULFM
  case, typed ERR_PROC_FAILED under ``--ft-continue``, is
  ``tests/test_torch_ft_jobs.py``).
"""

import os
import sys
import textwrap
import time
import types

import numpy as np
import pytest

from ompi_release_tpu.coll import native_exec as jnx
from ompi_release_tpu_torch.coll import native_exec as nx
from ompi_release_tpu_torch.coll import plan as cplan
from ompi_release_tpu_torch.mca import var as mca_var
from ompi_release_tpu_torch.tools.tpurun import Job
from ompi_release_tpu_torch.utils.errors import ErrorCode, MPIError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ROUNDS = [
    {"depth": 2,
     "streams": [(0, [(b"PRE0", b"MID0", 64, 0, 64, ((0, 0, 0, 64),))])],
     "rsrcs": [(1, [(0, 24, 0, 24, b"PRE1", b"MID1")])]},
    {"depth": 2,
     "streams": [(1, [(b"PRE2", b"MID2", 24, 0, 24, ((1, 0, 0, 24),))])],
     "rsrcs": [(0, [(1, 64, 0, 64, b"PRE3", b"MID3")])]},
]


class TestBlob:
    def test_blob_matches_the_jax_package(self):
        assert nx.build_blob(7, [64], [24, 64], [3, 5], ROUNDS) == \
            jnx.build_blob(7, [64], [24, 64], [3, 5], ROUNDS)

    def test_round_trip_through_c_parser(self):
        """A two-round descriptor table parses: counts and the 8-aligned
        pool layout come back through the handle."""
        from ompi_release_tpu_torch.native.bindings import PlanExec

        px = PlanExec(nx.build_blob(7, [64], [24, 64], [3, 5], ROUNDS))
        try:
            assert (px.round_count, px.input_count, px.pool_count,
                    px.pool_total) == (2, 1, 2, 88)
            assert px.pool_view().nbytes == 88
        finally:
            px.close()

    def test_garbage_blob_is_rejected(self):
        from ompi_release_tpu_torch.native.bindings import PlanExec

        with pytest.raises(MPIError):
            PlanExec(b"not a descriptor table at all")

    def test_align8(self):
        assert [nx._align8(v) for v in (0, 1, 7, 8, 9)] == \
            [jnx._align8(v) for v in (0, 1, 7, 8, 9)] == [0, 8, 8, 8, 16]


def _arena_of(mod, *regions):
    rng = np.random.default_rng(0xBEEF)
    arrs = [np.frombuffer(r, dtype=np.uint8) for r in regions]
    arena, bounds = mod._build_arena(rng, arrs, [])
    return arena, np.frombuffer(arena, dtype=np.uint8), bounds


def _match(mod, payload, *regions):
    arena, a_arr, bounds = _arena_of(mod, *regions)
    return mod._match_payload(payload, arena, a_arr, bounds)


_rng = np.random.default_rng(1)
_R0, _R1, _DUP, _TAIL = (_rng.bytes(64), _rng.bytes(64), _rng.bytes(32),
                         _rng.bytes(32))
MATCH_CASES = {
    "whole": (_R0, (_R0,), ((0, 0, 0, 64),)),
    "slice": (_R0[16:48], (_R0,), ((0, 0, 16, 32),)),
    "two_regions": (_R0[:32] + _R1[32:], (_R0, _R1),
                    ((0, 0, 0, 32), (0, 1, 32, 32))),
    "duplicate_lowest": (_DUP, (_DUP, _DUP), ((0, 0, 0, 32),)),
    "duplicate_longest": (_DUP + _TAIL, (_DUP, _DUP + _TAIL),
                          ((0, 1, 0, 64),)),
}


class TestMatchPayload:
    @pytest.mark.parametrize("case", sorted(MATCH_CASES))
    def test_maps_match_the_jax_package(self, case):
        payload, regions, want = MATCH_CASES[case]
        assert _match(nx, payload, *regions) == want
        assert _match(jnx, payload, *regions) == want

    def test_adjacent_spans_merge(self):
        r0 = np.random.default_rng(3).bytes(256)
        assert len(_match(nx, r0, r0)) == 1

    @pytest.mark.parametrize("how", ["foreign", "tiny"])
    def test_unprovable_payload_fails(self, how):
        rng = np.random.default_rng(5)
        r0 = rng.bytes(64)
        payload = rng.bytes(32) if how == "foreign" else r0[:8]
        with pytest.raises(nx._ProbeFail):
            _match(nx, payload, r0)
        with pytest.raises(jnx._ProbeFail):
            _match(jnx, payload, r0)


class _State:
    def __init__(self):
        rnd = cplan.WireRound(((1, (((4,), "int32"),)),), ((1, 1),),
                              ((1, (None,)),), 9, 2)
        self.plan = cplan.WirePlan(0, 1, [rnd], 1000)
        self.why = None


class TestWithdrawal:
    def test_cvar_off_withdraws(self):
        st = _State()
        mca_var.set_value("coll_plan_native", 0)
        try:
            assert nx.try_compile(st, object(), None, (), {}) is None
        finally:
            mca_var.VARS.unset("coll_plan_native")
        assert "coll_plan_native=0" in st.why

    def test_missing_symbols_withdraw(self, monkeypatch):
        st = _State()
        monkeypatch.setattr(nx, "available", lambda: False)
        assert nx.try_compile(st, object(), None, (), {}) is None
        assert "symbols absent" in st.why

    def test_untemplated_round_withdraws(self):
        """A send slot without a frame template (shm handoff, legacy
        framing) keeps the plan on PlannedXchg."""

        class _M:
            class router:
                class _nw:
                    pass

                @staticmethod
                def tuning():
                    return types.SimpleNamespace(arbiter=None)

        st = _State()
        st.plan.rounds[0].recvs_meta = ((1, (((4,), "int32"),)),)
        st.comm = None
        assert nx.try_compile(st, _M(), None, (), {}) is None
        assert st.why == "_Ineligible: untemplated send slot"

    @pytest.mark.parametrize("same_host", [True, False])
    def test_message_beyond_the_ring_withdraws(self, same_host):
        """A message larger than the co-hosted peer's shm ring keeps the
        plan on PlannedXchg (the C leg waits on a full ring); across
        hosts, or within the ring, the gate passes."""
        class _Nw:
            my_pidx = 0

            def _same_host(self, p):
                return same_host

            def _cap(self, p):
                return ("tok", 4, 8 << 20)

            def pipeline_segsize(self):
                return 1 << 20

        def plan_of(elems):
            rnd = cplan.WireRound(((1, (((elems,), "float32"),)),),
                                  ((1, 1),), ((1, (None,)),), 9, 2,
                                  recvs_meta=((1, (((elems,), "float32"),)),))
            return cplan.WirePlan(0, 1, [rnd], 1000)

        nx._check_ring_fit(plan_of(2 << 20), _Nw())  # 8 MiB: fits
        if same_host:
            with pytest.raises(nx._Ineligible, match="exceeds the"):
                nx._check_ring_fit(plan_of((2 << 20) + 1), _Nw())
        else:
            nx._check_ring_fit(plan_of(64 << 20), _Nw())

    @pytest.mark.parametrize("seg", [8 << 20, 0])
    def test_fragment_record_beyond_the_ring_withdraws(self, seg):
        """A message within the ring whose one fragment's ring record
        (payload + 28 bytes) does not fit it keeps the plan on
        PlannedXchg: on a CPU job with 1 MiB rings, a native allgather
        of 1 MiB messages waited on such a record until its timeout."""
        class _Nw:
            my_pidx = 0

            def _same_host(self, p):
                return True

            def _cap(self, p):
                return ("tok", 4, 8 << 20)

            def pipeline_segsize(self):
                return seg

        def plan_of(nbytes):
            meta = ((1, (((nbytes,), "uint8"),)),)
            rnd = cplan.WireRound(meta, ((1, 1),), ((1, (None,)),), 9, 2,
                                  recvs_meta=meta)
            return cplan.WirePlan(0, 1, [rnd], 1000)

        nx._check_ring_fit(plan_of((8 << 20) - 28), _Nw())
        with pytest.raises(nx._Ineligible, match="fragment record"):
            nx._check_ring_fit(plan_of((8 << 20) - 27), _Nw())

    def test_try_compile_never_raises(self):
        class _NoPlan:
            plan = None
            why = None

        assert nx.try_compile(_NoPlan(), object(), None, (), {}) is None

        class _Hostile:
            def __getattr__(self, k):
                raise RuntimeError("boom")

        st = _State()
        assert nx.try_compile(st, _Hostile(), None, (), {}) is None
        assert st.why


class _FakeModule:
    """The slice of the hier-module contract PlannedXchg uses."""

    def __init__(self, arrivals):
        self.arrivals = arrivals
        self.sent = []

        class _C:
            name = "fake_comm"

        self.comm = _C()

    def _send_all_planned(self, rnd, sends):
        self.sent.append((rnd, sends))

    def _reap(self, recvs, cb, timeout_ms, record=True):
        for src, cnt in sorted(recvs.items()):
            for k in range(cnt):
                cb(src, self.arrivals[src][k])


def _one_round_plan(peer=1, src=2, shape=(8,), dtype="int32"):
    rnd = cplan.WireRound(((peer, ((shape, dtype),)),), ((src, 1),),
                          ((peer, (None,)),), 11, 2)
    return cplan.WirePlan(0, 1, [rnd], 1000)


class TestPlannedXchg:
    def test_planned_exchange_sends_the_schedules_arrays(self):
        arr = np.arange(8, dtype=np.int32)
        assert cplan._as_nd(arr) is arr
        m = _FakeModule({2: [np.ones(3, np.int32)]})
        got = cplan.PlannedXchg(m, _one_round_plan()).exchange(
            {1: [arr]}, {2: 1})
        assert got[2][0].tolist() == [1, 1, 1]
        assert m.sent[0][1][1][0] is arr  # the same object: no copy

    def test_round_meta_names_tensors_by_storage(self):
        import torch

        t = torch.arange(8, dtype=torch.float32).to(torch.bfloat16)
        assert cplan._round_meta({1: [t]}) == ((1, (((8,), "uint16"),)),)

    def test_planned_exchange_divergence_is_typed(self):
        m = _FakeModule({2: [np.ones(3, np.int32)]})
        px = cplan.PlannedXchg(m, _one_round_plan())
        with pytest.raises(MPIError) as ei:
            px.exchange({1: [np.zeros((9, 9), np.float64)]}, {2: 1})
        assert ei.value.code == ErrorCode.ERR_INTERN
        assert "diverged" in str(ei.value)


class TestPoolAliasing:
    def test_materialized_round_is_a_copy_of_the_pool(self):
        """The pool is reused by the next fire: what a round hands the
        schedule must not change when the pool is overwritten."""
        npl = nx.NativePlan()
        npl.pool_rounds = [[(2, [(0, 0, (4,), np.dtype(np.float32), 16),
                                 (1, 16, (2,), np.dtype(np.uint16), 4)])]]
        x = nx.NativeXchg.__new__(nx.NativeXchg)
        x.np = npl
        pool = np.zeros(24, np.uint8)
        pool[:16] = np.arange(4, dtype=np.float32).view(np.uint8)
        pool[16:20] = np.array([7, 9], np.uint16).view(np.uint8)
        x._pool = pool
        got = x._materialize(0)[2]
        pool[:] = 0xFF  # the next fire lands other bytes
        assert got[0].tolist() == [0.0, 1.0, 2.0, 3.0]
        assert got[1].tolist() == [7, 9] and got[1].dtype == np.uint16
        assert not np.shares_memory(got[0], pool)


# ---------------------------------------------------------------------------
# real 2-process jobs of the port
# ---------------------------------------------------------------------------

APP_PRELUDE = textwrap.dedent("""
    import os, sys, time
    sys.path.insert(0, %r)
    import numpy as np
    import torch
    import ompi_release_tpu_torch as mpi
    from ompi_release_tpu_torch.coll import plan as cplan
    from ompi_release_tpu_torch.mca import pvar, var as mca_var
    from ompi_release_tpu_torch.runtime.runtime import Runtime

    def _pv(name):
        p = pvar.PVARS.lookup(name)
        return float(p.read()) if p is not None else 0.0

    world = mpi.init(cli_args=["--mca", "runtime_virtual_ranks", "4"],
                     device="cpu")
    rt = Runtime.current()
    me = rt.bootstrap["process_index"]
    off = rt.local_rank_offset
    n = world.size
    mca_var.set_value("hier_inter_algorithm", "recursive_doubling")

    def rows(f):
        return np.stack([f(off + i) for i in range(4)])
""" % REPO)


def _run_job(tmp_path, capfd, body, n=2, timeout=180, job_kw=None,
             name="app"):
    app = tmp_path / f"{name}.py"
    app.write_text(APP_PRELUDE + textwrap.dedent(body))
    job = Job(n, [sys.executable, str(app)], [], heartbeat_s=0.5,
              miss_limit=8, **(job_kw or {}))
    t0 = time.monotonic()
    rc = job.run(timeout_s=timeout)
    out = capfd.readouterr()
    return rc, out.out + out.err, time.monotonic() - t0, job


class TestNativeJobs:
    def test_native_engages_bitwise_stable(self, tmp_path, capfd):
        """Recursive-doubling allreduce (f32, non-exact folds) and bcast
        over 2 processes: the plan freezes on fire 1, compiles natively,
        and every later fire runs C-side — fires counted, zero
        fallbacks, zero forced copies, every fire bitwise its
        interpreted twin (coll_compiled=0), and a result of fire k
        unchanged after fire k+1 landed other bytes in the pool."""
        rc, out, _, _ = _run_job(tmp_path, capfd, """
            x1 = rows(lambda r: np.sin(np.arange(3000, dtype=np.float32)
                                       * (r + 1)).astype(np.float32))
            x2 = rows(lambda r: np.cos(np.arange(3000, dtype=np.float32)
                                       + r).astype(np.float32))
            mca_var.set_value("coll_compiled", 0)
            w1 = world.allreduce(x1).numpy().copy()
            w2 = world.allreduce(x2).numpy().copy()
            wb = world.bcast(x1, root=5).numpy().copy()
            mca_var.VARS.unset("coll_compiled")
            held = []
            for it in range(5):
                a = world.allreduce(x1)
                held.append((a, a.numpy().copy()))
                assert a.numpy().tobytes() == w1.tobytes()
                b = world.allreduce(x2)
                assert b.numpy().tobytes() == w2.tobytes()
                assert world.bcast(x1, root=5).numpy().tobytes() == \\
                    wb.tobytes()
            for a, snap in held:  # fire k unchanged after fire k+1
                assert a.numpy().tobytes() == snap.tobytes()
            st = [s for k, s in cplan._span_states.items()
                  if k[1][0] == "allreduce"]
            assert st and all(s.last == "native" for s in st), \\
                [(s.last, s.why) for s in st]
            fires = _pv("plan_native_fires")
            assert fires >= 12, fires
            assert _pv("plan_native_fallbacks") == 0
            # the bcast root receives nothing: its plan has no pool
            assert _pv("plan_pool_hits") >= 8  # 4 replays x 2 allreduces
            assert _pv("plan_pool_bytes") > 0
            assert _pv("wire_native_fallback_copies") == 0
            world.barrier()
            print(f"NATIVE-OK {me} fires={fires}", flush=True)
            mpi.finalize()
        """)
        assert rc == 0, out
        for me in range(2):
            assert f"NATIVE-OK {me} " in out, out

    def test_mixed_fleet_bitwise_parity(self, tmp_path, capfd):
        """One worker opts out (cvar off): its fires replay through
        PlannedXchg, the other's go native, and the wire bytes being
        the contract, the results stay bitwise equal on both."""
        rc, out, _, _ = _run_job(tmp_path, capfd, """
            if me == 1:
                mca_var.set_value("coll_plan_native", 0)
            x = rows(lambda r: np.arange(128, dtype=np.int32) * (r + 1))
            want = sum(np.arange(128, dtype=np.int32) * (r + 1)
                       for r in range(n))
            for it in range(4):
                got = world.allreduce(x).numpy()
                np.testing.assert_array_equal(got[0], want)
            fires = _pv("plan_native_fires")
            assert (fires == 0) if me == 1 else (fires >= 2), fires
            world.barrier()
            print(f"MIXED-OK {me} fires={fires}", flush=True)
            mpi.finalize()
        """)
        assert rc == 0, out
        for me in range(2):
            assert f"MIXED-OK {me} " in out, out

    def test_killed_worker_between_native_fires_ends_the_job(
            self, tmp_path, capfd):
        """A worker SIGKILLed between native fires: the job ends with a
        non-zero exit code well inside its time limit — the survivor's
        C fire returns every slice and its deadline is the plan's
        wire_coll_timeout_ms snapshot, so nothing hangs."""
        rc, out, dt, job = _run_job(tmp_path, capfd, """
            mca_var.set_value("wire_coll_timeout_ms", 8000)
            x = rows(lambda r: np.arange(64, dtype=np.int32) * (r + 1))
            for it in range(3):  # freeze + native fires
                world.allreduce(x)
            assert _pv("plan_native_fires") >= 1
            world.barrier()
            if me == 1:
                time.sleep(0.3)
                import signal
                os.kill(os.getpid(), signal.SIGKILL)
            for it in range(50):
                world.allreduce(x)
            print("SURVIVED", flush=True)
            mpi.finalize()
        """, timeout=120, name="kill_app")
        assert rc != 0, out
        assert "SURVIVED" not in out
        assert dt < 60, f"the job took {dt:.1f}s to end"
        # the aborted workers never released their rings: the job's
        # end-of-job reap unlinks them (rings carry the owner's pid)
        import glob

        pids = [p.pid for p in job.procs.values()]
        assert not [f for pid in pids
                    for f in glob.glob(f"/dev/shm/onw-{pid:x}-*")]
