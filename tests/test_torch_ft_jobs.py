"""The port's ULFM recovery jobs held against the JAX package's
(``tests/test_ft_ulfm.py`` ``TestRecoveryJobs``,
``tests/test_native_exec.py::test_sigkill_mid_plan_fire_is_typed_and_fast``).

Each job runs ONE app body through both packages' ``tpurun`` ``Job``
(the preludes of ``tests/test_torch_unified_world.py``: the JAX package's
workers on virtual CPU devices, the port's on virtual ranks of the host)
under the failure policy and chaos injection the reference test uses,
with the parity harness's heartbeats (every 0.5 s, miss limit 16: on a
host shared by parallel test workers a worker's heartbeat thread is
starved for over a second now and then, which a 0.9 s window promotes
to a failure; the deaths these jobs inject reach the launcher through
waitpid at once, heartbeats or not); every surviving or
final worker dumps its results to an npz file and the dumps are compared
bitwise, worker by worker: the final state after the rollback, the
recovery count, the survivors' world size, the steps lost and the
``ft_*`` pvars. In the port every dead peer surfaces as
``ERR_PROC_FAILED``/``ERR_REVOKED`` well inside the wire's 30 s bound.

Two jobs are the port's alone: a 3-worker job in which a dpm pair
exists, a worker dies, and the survivors shrink and allreduce on the
shrunk world; and the mid-plan SIGKILL of the C plan executor under
``--ft-continue`` (the JAX package runs it without the C executor's
fault word; the port's survivors see the typed error through it).
"""

import glob
import os
import textwrap

import numpy as np
import pytest

from ompi_release_tpu.tools.tpurun import Job as JaxJob
from ompi_release_tpu_torch.runtime.state import JobState
from ompi_release_tpu_torch.tools.tpurun import Job as PortJob

from test_torch_unified_world import (
    DUMP_EPILOGUE, JAX_PRELUDE, PARITY_MCA, PORT_PRELUDE, REPO,
)

#: the FT pieces by package, and the reference app's step: every local
#: rank contributes (step + 1) * (world rank + 1), so a step's sum has
#: a closed form over the ranks alive in it
FT_PRELUDE = textwrap.dedent("""
    import importlib, time
    _ft = importlib.import_module(mpi.__name__ + ".ft")
    _sensor = importlib.import_module(mpi.__name__ + ".ft.sensor")
    _elastic = importlib.import_module(mpi.__name__ + ".parallel.elastic")
    Checkpointer = _ft.Checkpointer
    FtTester = _sensor.FtTester
    ElasticStep = _elastic.ElasticStep
    OUT = {}
    T = {}

    def _pv(name):
        p = pvar.PVARS.lookup(name)
        return float(p.read()) if p is not None else 0.0

    world = init()
    rt = Runtime.current()
    me = rt.bootstrap["process_index"]

    def step_fn(step, state, comm):
        wrs = [comm.group.world_rank(i) for i in comm.local_comm_ranks]
        contrib = np.stack(
            [np.full(4, (step + 1) * (wr + 1), np.float32)
             for wr in wrs])
        T["enter"] = time.monotonic()
        try:
            got = npy(comm.allreduce(contrib))
        except MPIError:
            T["detect"] = time.monotonic() - T["enter"]
            raise
        return np.asarray(state) + got[:1]

    def ckpt():
        return Checkpointer(os.path.join(
            os.environ["FT_JOB_DIR"], PKG, "rank%d" % me))
""")


def _run(job_cls, prelude, body, tmp, name, n, nvirt, job_kw, timeout):
    app = tmp / f"{name}.py"
    app.write_text(prelude % {"repo": REPO, "nvirt": nvirt}
                   + FT_PRELUDE + textwrap.dedent(body) + DUMP_EPILOGUE)
    keep = dict(os.environ)
    os.environ.update({"PARITY_DUMP": str(tmp / "dump"),
                       "FT_JOB_DIR": str(tmp / "ck")})
    try:
        job = job_cls(n, [os.sys.executable, str(app)], list(PARITY_MCA),
                      heartbeat_s=0.5, miss_limit=16, **job_kw)
        rc = job.run(timeout_s=timeout)
    finally:
        os.environ.clear()
        os.environ.update(keep)
    return rc, job


def _ft_parity(tmp_path_factory, body, name, *, n=3, nvirt=2,
               job_kw=None, timeout=240, pkgs=("jax", "torch")):
    """Run ``body`` through both packages' jobs; returns (dumps, jobs):
    ``dumps[pkg][pidx]`` for every worker that dumped."""
    tmp = tmp_path_factory.mktemp(name)
    (tmp / "dump").mkdir()
    dumps, jobs = {}, {}
    for pkg, cls, prelude in (("jax", JaxJob, JAX_PRELUDE),
                              ("torch", PortJob, PORT_PRELUDE)):
        if pkg not in pkgs:
            continue
        rc, job = _run(cls, prelude, body, tmp, f"{pkg}_app", n, nvirt,
                       dict(job_kw or {}), timeout)
        assert rc == 0, f"the {pkg} job failed ({rc})"
        assert job.job_state.visited(JobState.TERMINATED)
        jobs[pkg] = job
        dumps[pkg] = {
            p: dict(np.load(tmp / "dump" / f"{pkg}-{p}.npz"))
            for p in range(n)
            if (tmp / "dump" / f"{pkg}-{p}.npz").exists()}
    return dumps, jobs


def _assert_same(dumps):
    assert sorted(dumps["jax"]) == sorted(dumps["torch"])
    for p in dumps["jax"]:
        jd, td = dumps["jax"][p], dumps["torch"][p]
        assert sorted(jd) == sorted(td), p
        for k in jd:
            a, b = np.asarray(jd[k]), np.asarray(td[k])
            assert a.shape == b.shape and a.dtype == b.dtype, (p, k)
            assert a.tobytes() == b.tobytes(), (p, k, a, b)


def _no_rings_left(job):
    pids = {p.pid for p in job.procs.values()} | job._local_pids
    assert not [f for pid in pids
                for f in glob.glob(f"/dev/shm/onw-{pid:x}-*")]


SHRINK_BODY = """
STEPS = 8
es = ElasticStep(world, step_fn, ckpt(), policy="shrink",
                 checkpoint_every=1, tester=FtTester.from_cvars(me))
state, stats = es.run(np.zeros((1, 4), np.float32), STEPS)
# steps 0-2 on the 6-rank world (sum(wr+1) = 21), steps 3-7 on the
# 4 survivors (10)
exp = (sum((s + 1) * 21 for s in range(0, 3))
       + sum((s + 1) * 10 for s in range(3, 8)))
assert np.array_equal(state, np.full((1, 4), float(exp), np.float32))
fail = stats["failures"][0][1]
OUT["typed"] = np.int32("ERR_PROC_FAILED" in fail
                        or "ERR_REVOKED" in fail)
OUT["state"] = np.asarray(state)
OUT["recoveries"] = np.int32(stats["recoveries"])
OUT["steps_lost"] = np.int32(stats["steps_lost"])
OUT["size"] = np.int32(es.comm.size)
OUT["local"] = np.int32(len(es.comm.local_comm_ranks))
OUT["shrunk_spans"] = np.int32(es.comm.spans_processes)
OUT["pv"] = np.float64([_pv("ft_failures_detected"),
                        _pv("ft_recoveries"), _pv("ft_revokes") >= 1,
                        _pv("ft_recovery_seconds") > 0])
try:
    world.allreduce(np.zeros((2, 2), np.float32))
    raise AssertionError("revoked world still worked")
except MPIError as e:
    OUT["old_world"] = np.int32(e.code.name in ("ERR_REVOKED",
                                                "ERR_PROC_FAILED"))
if PKG == "torch":
    from ompi_release_tpu_torch.ft import ulfm
    assert ulfm.FT_CID_BASE <= es.comm.cid < ulfm.FT_CID_LIMIT
    assert T["detect"] < 15, T  # far inside the 30 s wire bound
mpi.finalize()
"""

RESPAWN_BODY = """
STEPS = 8
tester = FtTester.from_cvars(me)
if SECOND and me == 1 and not os.environ.get("OMPITPU_INCARNATION"):
    # the SECOND failure: rank 1's first incarnation dies a few steps
    # after recovery #1 completes
    tester.kill_step = 6
es = ElasticStep(world, step_fn, ckpt(), policy="respawn",
                 checkpoint_every=1, recover_timeout_s=120,
                 tester=tester)
state, stats = es.run(np.zeros((1, 4), np.float32), STEPS)
exp = sum((s + 1) * 21 for s in range(STEPS))
assert np.array_equal(state, np.full((1, 4), float(exp), np.float32))
assert es.comm.size == 6 and es.comm.name.startswith("rebuild")
OUT["state"] = np.asarray(state)
OUT["size"] = np.int32(es.comm.size)
OUT["incarnation"] = np.int32(int(os.environ.get("OMPITPU_INCARNATION",
                                                 "0") or 0))
if PKG == "torch":
    if "detect" in T:
        assert T["detect"] < 15, T
    # the rebuilt world's allreduce holds after recovery, bitwise
    x = np.stack([np.float32([wr, 1.0]) for wr in
                  [es.comm.group.world_rank(i)
                   for i in es.comm.local_comm_ranks]])
    assert np.array_equal(npy(es.comm.allreduce(x))[0],
                          np.float32([15.0, 6.0]))
mpi.finalize()
"""


class TestRecoveryJobs:
    def test_kill_mid_allreduce_shrink_recovers_exact_loss(
            self, tmp_path_factory):
        """Worker 2 is SIGKILLed at step 3 while its peers are in that
        step's allreduce; the survivors detect it typed, revoke, shrink
        to 4 ranks over 2 workers (an FT-band cid in the port), roll
        back and finish with the exact degraded sum — in both
        packages, bitwise."""
        dumps, jobs = _ft_parity(
            tmp_path_factory, SHRINK_BODY, "ft_shrink",
            job_kw={"on_failure": "continue", "ft_inject": (2, 3)})
        _assert_same(dumps)
        assert sorted(dumps["torch"]) == [0, 1]
        for d in dumps["torch"].values():
            assert d["typed"] == 1 and d["old_world"] == 1
            assert d["size"] == 4 and d["local"] == 2
            assert d["recoveries"] == 1 and d["steps_lost"] == 0
            assert d["pv"].tolist() == [1.0, 1.0, 1.0, 1.0]
        assert jobs["torch"]._ft_failed_ranks == {3}
        _no_rings_left(jobs["torch"])

    def test_p2p_recv_on_dead_peer_raises_typed_error(
            self, tmp_path_factory):
        """A blocking p2p recv whose sender process dies raises
        ERR_PROC_FAILED within the detection interval — not after the
        30 s ``pml_wire_timeout``."""
        dumps, _ = _ft_parity(tmp_path_factory, """
            if me == 1:
                time.sleep(1.0)
                import signal
                os.kill(os.getpid(), signal.SIGKILL)
            t0 = time.monotonic()
            try:
                world.recv(source=2, rank=0)  # rank 2 lives on pidx 1
                raise AssertionError("recv from dead peer returned")
            except MPIError as e:
                dt = time.monotonic() - t0
                OUT["code"] = np.str_(e.code.name)
                assert dt < 15, f"typed error took {dt:.1f}s"
            mpi.finalize()
        """, "ft_p2p", n=2, nvirt=2, timeout=120,
            job_kw={"on_failure": "continue"})
        _assert_same(dumps)
        assert str(dumps["torch"][0]["code"]) == "ERR_PROC_FAILED"

    def test_exit_zero_without_fin_is_promoted(self, tmp_path_factory):
        """A worker that exits 0 WITHOUT sending FIN is lifeline-lost,
        not finished: the survivor's collective raises the typed
        error."""
        dumps, _ = _ft_parity(tmp_path_factory, """
            if me == 1:
                time.sleep(1.0)
                os._exit(0)  # exit 0, no FIN, no finalize
            t0 = time.monotonic()
            try:
                step_fn(0, np.zeros((1, 4), np.float32), world)
                raise AssertionError("collective with dead peer ran")
            except MPIError as e:
                dt = time.monotonic() - t0
                OUT["typed"] = np.int32(e.code.name in (
                    "ERR_PROC_FAILED", "ERR_REVOKED"))
                assert dt < 20, f"typed error took {dt:.1f}s"
            mpi.finalize()
        """, "ft_nofin", n=2, nvirt=2, timeout=120,
            job_kw={"on_failure": "continue"})
        _assert_same(dumps)
        assert dumps["torch"][0]["typed"] == 1

    @pytest.mark.parametrize("second", [False, True],
                             ids=["one_failure", "two_failures"])
    def test_kill_then_respawn_rebuilds_full_world_exact_loss(
            self, tmp_path_factory, second):
        """Under ``--enable-recovery`` the launcher respawns the killed
        worker; the replacement rejoins at the new epoch, the survivors
        re-dial it, and ``recover('respawn')`` rebuilds the full 6-rank
        world on an epoch-derived cid minted alike everywhere; everyone
        resumes from the agreed checkpoint and reaches the no-failure
        sum. With ``two_failures`` worker 1 dies too, after the first
        recovery: the lineage anchor pairs its rebuild."""
        dumps, jobs = _ft_parity(
            tmp_path_factory, f"SECOND = {second}\n" + RESPAWN_BODY,
            "ft_respawn2" if second else "ft_respawn",
            timeout=300, job_kw={"on_failure": "restart",
                                 "max_restarts": 2, "ft_inject": (2, 3)})
        _assert_same(dumps)
        assert sorted(dumps["torch"]) == [0, 1, 2]
        assert dumps["torch"][2]["incarnation"] == 1
        job = jobs["torch"]
        assert job._restarts.get(3) == 1
        assert job._restarts.get(2) == (1 if second else None)
        _no_rings_left(job)


class TestPortOnlyFtJobs:
    def test_dpm_pair_then_death_then_shrink(self, tmp_path_factory):
        """3 workers x 2 ranks: workers 0 and 1 form a dpm pair (its
        cids from a block above the FT band) and merge it, then worker
        2 dies. In one epoch the survivors shrink every comm they hold
        across processes — the world, a dup of it whose cid equals the
        merge's offset in its dpm block (two lineages a plain modulo
        would put on one slot), and the merged pair — and allreduce on
        each rebuild: three distinct cids in the FT band, none on the
        pair's block."""
        dumps, _ = _ft_parity(tmp_path_factory, """
            from ompi_release_tpu_torch.comm import dpm
            from ompi_release_tpu_torch.ft import ulfm
            from ompi_release_tpu_torch.utils.cids import DPM_CID_BASE
            dups = [world.dup() for _ in range(8)]
            subs = world.split([0, 0, 1, 1, 2, 2])
            local = subs[rt.local_rank_offset]
            if me == 0:
                port = dpm.open_port()
                dpm.publish_name("ft-pair", port)
                inter = dpm.comm_accept(local, port, timeout_s=60)
            elif me == 1:
                port = dpm.lookup_name("ft-pair", timeout_s=60)
                inter = dpm.comm_connect(local, port, timeout_s=60)
            else:
                time.sleep(1.5)
                import signal
                os.kill(os.getpid(), signal.SIGKILL)
            assert inter.cid >= DPM_CID_BASE
            merged = inter.merge(high=(me == 1))
            assert merged.spans_processes and merged.size == 4
            twin = [c for c in dups
                    if c.cid == (merged.cid - DPM_CID_BASE) % 8192]
            assert len(twin) == 1, (merged.cid, [c.cid for c in dups])
            try:
                world.allreduce(np.ones((2, 3), np.float32))
                world.allreduce(np.ones((2, 3), np.float32))
                raise AssertionError("collective with dead peer ran")
            except MPIError as e:
                assert e.code.name in ("ERR_PROC_FAILED", "ERR_REVOKED")
            world.revoke()
            shrunk = [c.shrink() for c in (world, twin[0], merged)]
            assert len({c.cid for c in shrunk}) == 3
            sums = []
            for c in shrunk:
                assert c.size == 4
                assert ulfm.FT_CID_BASE <= c.cid < ulfm.FT_CID_LIMIT
                assert c.cid != inter.cid
                x = np.stack([np.float32([c.group.world_rank(i) + 1])
                              for i in c.local_comm_ranks])
                got = npy(c.allreduce(x))
                assert got[0][0] == 1 + 2 + 3 + 4, got
                sums.append(got[0][0])
            OUT["sum"] = np.float32(sums)
            OUT["cids"] = np.int64([c.cid for c in shrunk])
            OUT["inter"] = np.int32(inter.cid)
            mpi.finalize()
        """, "ft_dpm", job_kw={"on_failure": "continue"},
            pkgs=("torch",), timeout=180)
        d = dumps["torch"]
        assert sorted(d) == [0, 1]
        # the two sides' handles: one block, reserved by the port's owner
        assert d[0]["inter"] // 256 == d[1]["inter"] // 256
        # both survivors minted the same three rebuild cids
        assert (d[0]["cids"] == d[1]["cids"]).all()

    def test_sigkill_mid_plan_fire_is_typed_and_fast(
            self, tmp_path_factory):
        """Worker 1 dies between native fires; the survivors' next fire
        surfaces ERR_PROC_FAILED (or the revoke after it) naming the
        dead process, well inside the detection interval — the C slice
        loop stops on the raised fault word and runs ``check_wait``."""
        dumps, _ = _ft_parity(tmp_path_factory, """
            off = rt.local_rank_offset
            x = np.stack([np.arange(64, dtype=np.int32) * (off + i + 1)
                          for i in range(2)])
            for it in range(3):  # freeze + native fires
                world.allreduce(x)
            assert me == 2 or _pv("plan_native_fires") >= 1
            world.barrier()
            if me == 1:
                time.sleep(0.5)
                import signal
                os.kill(os.getpid(), signal.SIGKILL)
            t0 = time.monotonic()
            try:
                for it in range(50):
                    world.allreduce(x)
                raise AssertionError("collective with dead peer ran")
            except MPIError as e:
                dt = time.monotonic() - t0
                assert e.code.name in ("ERR_PROC_FAILED", "ERR_REVOKED")
                assert dt < 20, f"typed error took {dt:.1f}s"
                if e.code.name == "ERR_PROC_FAILED":
                    assert "1" in str(e)
            OUT["ok"] = np.int32(1)
            mpi.finalize()
        """, "ft_native", job_kw={"on_failure": "continue"},
            pkgs=("torch",), timeout=180)
        assert sorted(dumps["torch"]) == [0, 2]
