"""The port's tpurun restart policy and ``tpu-migrate`` held against the
JAX package's (``tests/test_tpurun.py`` ``TestFailureDetection``'s
restart and budget cases, ``TestMigration``).

Each job runs one app body through both packages' ``Job`` (the preludes
of ``tests/test_torch_unified_world.py``, one rank per worker; a miss
limit of 16 beats, so that a worker starved on a host shared by parallel
test workers is not promoted to a failure by a late beat) and the
outcomes are compared: what each worker resumed from and finished
with, the restart budget used, the final placement and the excluded
hosts.

The migration app is not a timing race (the JAX package's test is):
its workers checkpoint a step at a time until the test releases them
through a file, and the test waits for each event it needs — the job
running, rank 1's first committed checkpoint, the moved rank's resume —
with a generous deadline, so the evacuation always lands mid-run. Each
worker checkpoints on its own: a checkpointer bound to the spanning
world barriers it at every save (``Checkpointer.quiesce``), and a moved
rank that resumes at another step than its peer pairs those barriers
wrongly until the wire's 60 s bound fails it — the race behind the JAX
package's flaky ``TestMigration``, whose app saves through the world.
"""

import os
import sys
import textwrap
import time

import pytest

from ompi_release_tpu.tools import tpu_migrate as jmigrate
from ompi_release_tpu.tools.tpurun import HostSpec as JHostSpec
from ompi_release_tpu.tools.tpurun import Job as JaxJob
from ompi_release_tpu_torch.runtime.state import JobState
from ompi_release_tpu_torch.tools import tpu_migrate as tmigrate
from ompi_release_tpu_torch.tools.tpurun import HostSpec as THostSpec
from ompi_release_tpu_torch.tools.tpurun import Job as PortJob

from test_torch_unified_world import JAX_PRELUDE, PORT_PRELUDE, REPO

PKGS = {
    "jax": (JaxJob, JAX_PRELUDE, JHostSpec, jmigrate),
    "torch": (PortJob, PORT_PRELUDE, THostSpec, tmigrate),
}

CK_PRELUDE = textwrap.dedent("""
    import importlib, time
    Checkpointer = importlib.import_module(mpi.__name__ + ".ft").Checkpointer
    world = init()
    rt = Runtime.current()
    pi = rt.bootstrap["process_index"]
    ck_dir = os.path.join(os.environ["FT_CK"], "rank%d" % pi)
    # a world checkpointer barriers the world at every save
    ck = (Checkpointer(ck_dir, comm=world, private_dir=True)
          if os.environ.get("FT_CK_WORLD") else Checkpointer(ck_dir))
    state = {"step": np.zeros((), np.int32)}
    latest = ck.latest_step()
    restored = latest is not None
    start = 0
    if restored:
        state = ck.restore(state, step=latest)
        start = int(np.asarray(state["step"]))
        print(f"RESUMED {pi} from {start}", flush=True)
""")


def _job(pkg, tmp, body, capfd, timeout=120, **kw):
    cls, prelude, _h, _m = PKGS[pkg]
    app = tmp / f"{pkg}_app.py"
    app.write_text(prelude % {"repo": REPO, "nvirt": 1} + CK_PRELUDE
                   + textwrap.dedent(body))
    ck = tmp / f"ck-{pkg}"
    ck.mkdir()
    keep = dict(os.environ)
    os.environ["FT_CK"] = str(ck)
    os.environ["FT_CK_WORLD"] = "1"
    try:
        job = cls(2, [sys.executable, str(app)], [], heartbeat_s=0.3,
                  miss_limit=16, **kw)
        rc = job.run(timeout_s=timeout)
    finally:
        os.environ.clear()
        os.environ.update(keep)
    out = capfd.readouterr()
    return rc, out.out + out.err, job


def _lines(out, *prefixes):
    return sorted(ln.split("] ", 1)[-1] for ln in out.splitlines()
                  if ln.split("] ", 1)[-1].startswith(prefixes))


class TestFailureDetection:
    def test_resilient_restart_resumes_from_checkpoint(self, tmp_path,
                                                       capfd):
        """A worker KILLED mid-job is respawned (same rank identity,
        fresh wire-up through the rejoin service) and resumes from its
        last committed checkpoint; both packages' jobs end rc 0 with
        the same resumes and results, after exactly one respawn."""
        body = """
            for step in range(start, 10):
                state["step"] = np.asarray(step + 1, np.int32)
                if step == 4 and not restored:
                    ck.save(step + 1, state)
                    ck.wait()
                    if pi == 1:
                        import signal
                        os.kill(os.getpid(), signal.SIGKILL)
            print(f"DONE {pi} step={int(state['step'])}", flush=True)
            mpi.finalize()
        """
        seen = {}
        for pkg in PKGS:
            rc, out, job = _job(pkg, tmp_path, body, capfd,
                                on_failure="restart", max_restarts=2)
            assert rc == 0, out
            assert job._restarts.get(2) == 1
            assert not job.job_state.visited(JobState.ABORTED)
            assert job.job_state.visited(JobState.TERMINATED)
            seen[pkg] = _lines(out, "RESUMED", "DONE")
        assert seen["jax"] == seen["torch"] == [
            "DONE 0 step=10", "DONE 1 step=10", "RESUMED 1 from 5"]

    def test_restart_budget_exhaustion_aborts(self, tmp_path, capfd):
        """A rank that keeps dying exhausts max_restarts and the job
        aborts, in both packages."""
        body = """
            if pi == 0:
                import signal
                os.kill(os.getpid(), signal.SIGKILL)
            time.sleep(30)
        """
        for pkg in PKGS:
            tmp = tmp_path / pkg
            tmp.mkdir()
            rc, out, job = _job(pkg, tmp, body, capfd, timeout=60,
                                on_failure="restart", max_restarts=1)
            assert rc != 0, (pkg, out)
            assert job._restarts.get(1) == 1, pkg
            assert job.job_state.visited(JobState.ABORTED), pkg


MIGRATE_BODY = """
if restored:
    open(os.path.join(os.environ["FT_CK"], "resumed-%d" % pi),
         "w").close()
release = os.path.join(os.environ["FT_CK"], "release")
deadline = time.monotonic() + 150
step = start
while not os.path.exists(release):
    assert time.monotonic() < deadline, "never released"
    step += 1
    state["step"] = np.asarray(step, np.int32)
    ck.save(step, state)
    ck.wait()
    time.sleep(0.05)
print(f"DONE {pi} resumed={int(restored)}", flush=True)
mpi.finalize()
"""


def _wait_for(cond, what, timeout=90.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


class TestMigration:
    """tpu-migrate (orte-migrate analogue): evacuate a host of a live
    job through the HNP's TAG_MIGRATE responder."""

    def test_migrate_off_host_resumes_elsewhere(self, tmp_path, capfd):
        """A 2-'host' fake-ssh job is asked to evacuate nodeB: the rank
        there is terminated (through the control plane: its old
        incarnation never finishes), remapped to nodeA (which stays
        excluded for later respawns), respawned through the launch
        agent, and resumes from its last committed checkpoint; the job
        completes rc 0 and the failure-restart budget is untouched —
        the same outcome in both packages."""
        import threading

        seen = {}
        for pkg in PKGS:
            tmp = tmp_path / pkg
            tmp.mkdir()
            log = tmp / "ssh_targets.log"
            agent = tmp / "fakessh"
            agent.write_text("#!/bin/sh\n"
                             f'echo "$1" >> {log}\n'
                             "shift\n"
                             'exec sh -c "$*"\n')
            agent.chmod(0o755)
            HostSpec, migrate = PKGS[pkg][2], PKGS[pkg][3]
            ck = tmp / "ck"
            ck.mkdir()
            results = {}
            job_box = {}

            def drive(ck=ck, migrate=migrate, results=results,
                      job_box=job_box):
                try:
                    _wait_for(lambda: "job" in job_box and job_box[
                        "job"].job_state.visited(JobState.RUNNING),
                        "the job to run")
                    job = job_box["job"]
                    # rank 1 committed a step: the move has a resume point
                    _wait_for(lambda: (ck / "rank1").is_dir() and any(
                        (ck / "rank1" / f / "COMMITTED").exists()
                        for f in os.listdir(ck / "rank1")),
                        "rank 1's first committed checkpoint")
                    results["reply"] = migrate.request_migration(
                        "127.0.0.1", job.hnp.port, "nodeB")
                    _wait_for(lambda: (ck / "resumed-1").exists(),
                              "the moved rank's resume", timeout=120)
                finally:
                    (ck / "release").touch()

            t = threading.Thread(target=drive, daemon=True)
            t.start()
            cls, prelude = PKGS[pkg][0], PKGS[pkg][1]
            app = tmp / "app.py"
            app.write_text(prelude % {"repo": REPO, "nvirt": 1}
                           + CK_PRELUDE + textwrap.dedent(MIGRATE_BODY))
            keep = dict(os.environ)
            os.environ["FT_CK"] = str(ck)
            try:
                job = cls(2, [sys.executable, str(app)], [],
                          heartbeat_s=0.3, miss_limit=16,
                          hosts=[HostSpec("nodeA", 2),
                                 HostSpec("nodeB", 2)],
                          map_by="node", launch_agent=str(agent),
                          on_failure="restart", max_restarts=2)
                job_box["job"] = job
                rc = job.run(timeout_s=240)
            finally:
                os.environ.clear()
                os.environ.update(keep)
            t.join(30)
            out = capfd.readouterr()
            out = out.out + out.err
            assert rc == 0, (pkg, out)
            reply = results.get("reply")
            assert reply and reply.get("ok"), (pkg, reply, out)
            assert job.rank_hosts[1].name == "nodeA"
            assert "nodeB" in job._excluded_hosts
            assert not job._restarts.get(2)
            assert not job.job_state.visited(JobState.ABORTED)
            assert job.job_state.visited(JobState.TERMINATED)
            targets = log.read_text().split()
            seen[pkg] = (reply["ranks"], _lines(out, "DONE"),
                         len(_lines(out, "RESUMED 1")),
                         targets.count("nodeA"), targets.count("nodeB"))
        assert seen["jax"] == seen["torch"] == (
            [1], ["DONE 0 resumed=0", "DONE 1 resumed=1"], 1, 2, 1)

    @pytest.mark.parametrize("pkg", list(PKGS))
    def test_migrate_refused_without_capacity(self, pkg, tmp_path,
                                              capfd):
        """Evacuating the only host is refused whole — no rank is
        killed on a request that cannot complete."""
        import threading

        cls, prelude, _h, migrate = PKGS[pkg]
        app = tmp_path / "app.py"
        app.write_text(prelude % {"repo": REPO, "nvirt": 1}
                       + textwrap.dedent("""
            import time
            world = init()
            while not os.path.exists(os.environ["FT_RELEASE"]):
                time.sleep(0.05)
            mpi.finalize()
        """))
        release = tmp_path / "release"
        job = cls(2, [sys.executable, str(app)], [], heartbeat_s=0.3,
                  miss_limit=16, on_failure="restart")
        results = {}

        def drive():
            try:
                _wait_for(lambda: job.job_state.visited(JobState.RUNNING),
                          "the job to run")
                results["reply"] = migrate.request_migration(
                    "127.0.0.1", job.hnp.port, "localhost")
            finally:
                release.touch()

        keep = dict(os.environ)
        os.environ["FT_RELEASE"] = str(release)
        t = threading.Thread(target=drive, daemon=True)
        t.start()
        try:
            rc = job.run(timeout_s=120)
        finally:
            os.environ.clear()
            os.environ.update(keep)
        t.join(30)
        assert rc == 0
        reply = results["reply"]
        assert not reply["ok"] and "cannot evacuate" in reply["error"]
        assert not job._restarts and not job._excluded_hosts
