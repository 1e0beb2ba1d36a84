"""The port's launcher (``ompi_release_tpu_torch/tools/tpurun.py``) held
against ``tests/test_tpurun.py``: real multi-process jobs of the port
over localhost — wire-up through the OOB coordinator during init, stdio
forwarding, exit-code aggregation, the pubsub name service, failure
detection (abnormal exit, heartbeat loss, a crash before wire-up)
driving the job state machine into its error states, the module CLI,
and the multi-host pieces (hostfile and host list, the slot / node /
ppr / seq mappers, the rankfile, the fake-ssh launch agent, real
addresses in the modex cards). Restart, migration and ``tpu_ps`` are
not ported yet; their cases are not here."""

import os
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from ompi_release_tpu.tools import tpurun as jtpurun
from ompi_release_tpu_torch.runtime.state import JobState, ProcState
from ompi_release_tpu_torch.tools.tpurun import (
    HostSpec, Job, map_ranks, parse_host_list, parse_hostfile,
    parse_rankfile,
)
from ompi_release_tpu_torch.utils.errors import MPIError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

APP_PRELUDE = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, %r)
    import ompi_release_tpu_torch as mpi
    from ompi_release_tpu_torch.runtime.runtime import Runtime

    def init():
        return mpi.init(device="cpu")
""" % REPO)


def _write_app(tmp_path, body, name="app.py"):
    p = tmp_path / name
    p.write_text(APP_PRELUDE + textwrap.dedent(body))
    return str(p)


class TestEndToEnd:
    def test_four_process_job(self, tmp_path, capfd):
        app = _write_app(tmp_path, """
            world = init()
            rt = Runtime.current()
            pi = rt.bootstrap["process_index"]
            pc = rt.bootstrap["process_count"]
            peers = rt.bootstrap["peer_cards"]
            assert pc == 4 and 0 <= pi < 4 and len(peers) == 4
            assert peers[pi]["pid"] == os.getpid()
            assert peers[pi]["platform"] == "cpu"
            assert world.size == 4 and world.spans_processes
            print(f"hello from {pi}/{pc}")
            mpi.finalize()
        """)
        job = Job(4, [sys.executable, app], [], heartbeat_s=0.3)
        rc = job.run(timeout_s=120)
        out = capfd.readouterr().out
        assert rc == 0, out
        for r in range(4):
            assert f"[rank {r}] hello from {r}/4" in out
        assert job.job_state.visited(JobState.RUNNING)
        assert job.job_state.visited(JobState.TERMINATED)
        assert all(s == ProcState.TERMINATED
                   for s in job.proc_state.values())

    def test_xcast_reaches_all_workers(self, tmp_path, capfd):
        app = _write_app(tmp_path, """
            world = init()
            payload = Runtime.current().agent.recv_xcast(timeout_ms=30000)
            print("got:" + payload.decode())
            mpi.finalize()
        """)
        job = Job(5, [sys.executable, app], [], heartbeat_s=0.3)

        def cast_when_running():
            for _ in range(600):
                if job.job_state.visited(JobState.RUNNING):
                    job.hnp.xcast(b"tree-payload")
                    return
                time.sleep(0.05)

        threading.Thread(target=cast_when_running, daemon=True).start()
        rc = job.run(timeout_s=120)
        out = capfd.readouterr().out
        assert rc == 0, out
        assert out.count("got:tree-payload") == 5

    def test_mca_vars_propagate(self, tmp_path, capfd):
        app = _write_app(tmp_path, """
            world = init()
            _ = world.pml
            from ompi_release_tpu_torch.mca import var as mca_var
            print("val=" + str(mca_var.get("pml_eager_limit", 0)))
            mpi.finalize()
        """)
        job = Job(2, [sys.executable, app], [("pml_eager_limit", "12345")],
                  heartbeat_s=0.3)
        rc = job.run(timeout_s=120)
        out = capfd.readouterr().out
        assert rc == 0, out
        assert out.count("val=12345") == 2

    def test_env_contract_matches_the_jax_launcher(self):
        """The OMPITPU_* contract a worker reads is the JAX package's:
        either launcher can start the other package's workers."""
        keys = {}
        for mod in (jtpurun, sys.modules[Job.__module__]):
            job = mod.Job(2, ["true"], [("x_probe", "1")])
            job.hnp = type("H", (), {"port": 4242})()
            keys[mod.__name__] = sorted(job._ompitpu_env(1))
        assert len(set(map(tuple, keys.values()))) == 1, keys


class TestPubsub:
    def test_publish_lookup_inside_job(self, tmp_path, capfd):
        app = _write_app(tmp_path, """
            world = init()
            rt = Runtime.current()
            pi = rt.bootstrap["process_index"]
            if pi == 0:
                import time
                time.sleep(0.4)
                rt.agent.publish_name("job-svc", "tpu-port:7")
                port = rt.agent.lookup_name("job-svc")
            else:
                port = rt.agent.lookup_name("job-svc", timeout_ms=20000)
            print("found:" + port)
            mpi.finalize()
        """)
        job = Job(3, [sys.executable, app], [], heartbeat_s=0.3)
        rc = job.run(timeout_s=120)
        out = capfd.readouterr().out
        assert rc == 0, out
        assert out.count("found:tpu-port:7") == 3


class TestPubsubPublicApi:
    def test_comm_publish_lookup_bridges_to_hnp(self, tmp_path, capfd):
        app = _write_app(tmp_path, """
            from ompi_release_tpu_torch.comm import (
                lookup_name, publish_name)
            world = init()
            pi = Runtime.current().bootstrap["process_index"]
            if pi == 0:
                publish_name("pub-api-svc", "tpu-port:5")
            port = lookup_name("pub-api-svc", timeout_s=20)
            print("found:" + port)
            mpi.finalize()
        """)
        job = Job(2, [sys.executable, app], [], heartbeat_s=0.3)
        rc = job.run(timeout_s=120)
        out = capfd.readouterr().out
        assert rc == 0, out
        assert out.count("found:tpu-port:5") == 2

    def test_singleton_table_and_errors(self):
        from ompi_release_tpu_torch.comm import (
            lookup_name, publish_name, unpublish_name)

        publish_name("solo-svc", "p:1")
        with pytest.raises(MPIError):
            publish_name("solo-svc", "p:2")
        assert lookup_name("solo-svc") == "p:1"
        unpublish_name("solo-svc")
        with pytest.raises(MPIError):
            unpublish_name("solo-svc")
        with pytest.raises(MPIError):
            lookup_name("solo-svc", timeout_s=0.05)


class TestFailureDetection:
    def test_abnormal_exit_aborts_job(self, tmp_path, capfd):
        app = _write_app(tmp_path, """
            import time
            world = init()
            if Runtime.current().bootstrap["process_index"] == 1:
                time.sleep(0.5)
                os._exit(3)
            time.sleep(600)
        """)
        job = Job(3, [sys.executable, app], [], heartbeat_s=0.3)
        rc = job.run(timeout_s=120)
        assert rc == 3
        assert job.job_state.visited(JobState.ABORTED)
        assert job.proc_state[2] == ProcState.ABORTED
        assert all(p.poll() is not None for p in job.procs.values())

    def test_aborted_job_leaves_no_shm_segment(self, tmp_path, capfd):
        """A worker hands a payload to a peer through a shm segment and
        the peer dies before it receives: the job fails, and the
        launcher unlinks the orphaned segment at job end."""
        app = _write_app(tmp_path, """
            import time
            import numpy as np
            world = init()
            rt = Runtime.current()
            if rt.bootstrap["process_index"] == 0:
                world.send(np.ones(1 << 16, np.float32), 1, tag=3, rank=0)
                time.sleep(600)
            time.sleep(0.5)
            os._exit(4)  # dies holding an unconsumed handoff
        """)
        job = Job(2, [sys.executable, app], [], heartbeat_s=0.3)
        rc = job.run(timeout_s=120)
        capfd.readouterr()
        assert rc == 4
        pids = [p.pid for p in job.procs.values()]
        import glob

        assert not [f for pid in pids
                    for f in glob.glob(f"/dev/shm/ompitpu-{pid}-*")]

    def test_heartbeat_loss_detected(self, tmp_path, capfd):
        app = _write_app(tmp_path, """
            import time
            world = init()
            rt = Runtime.current()
            if rt.bootstrap["process_index"] == 0:
                rt.agent.stop_heartbeats()
            time.sleep(600)
        """)
        job = Job(2, [sys.executable, app], [], heartbeat_s=0.3,
                  miss_limit=3)
        rc = job.run(timeout_s=120)
        assert rc != 0
        assert job.job_state.visited(JobState.ABORTED)
        assert job.proc_state[1] == ProcState.HEARTBEAT_FAILED

    def test_worker_crash_before_wireup(self, tmp_path, capfd):
        app = _write_app(tmp_path, """
            if int(os.environ["OMPITPU_NODE_ID"]) == 2:
                os._exit(7)
            world = init()
            import time; time.sleep(600)
        """)
        job = Job(2, [sys.executable, app], [], heartbeat_s=0.3)
        rc = job.run(timeout_s=120)
        assert rc == 7
        assert (job.job_state.visited(JobState.ABORTED)
                or job.job_state.visited(JobState.FAILED_TO_START))


class TestCli:
    def test_module_cli(self, tmp_path):
        app = _write_app(tmp_path, """
            world = init()
            print("cli-ok", Runtime.current().bootstrap["process_index"])
            mpi.finalize()
        """)
        env = dict(os.environ, PYTHONPATH=REPO)
        r = subprocess.run(
            [sys.executable, "-m", "ompi_release_tpu_torch.tools.tpurun",
             "-n", "2", "--timeout", "120", sys.executable, app],
            capture_output=True, text=True, env=env, timeout=180)
        assert r.returncode == 0, r.stderr
        assert "[rank 0] cli-ok 0" in r.stdout
        assert "[rank 1] cli-ok 1" in r.stdout

    def test_ring_example_over_two_workers(self):
        """The documented launch: the ring example's token crosses the
        process boundary twice a lap over all 8 ranks."""
        code = ("import sys; sys.path.insert(0, %r)\n"
                "from ompi_release_tpu_torch.examples import ring_tpu\n"
                "sys.exit(ring_tpu.main(device='cpu'))\n" % REPO)
        env = dict(os.environ, PYTHONPATH=REPO)
        r = subprocess.run(
            [sys.executable, "-m", "ompi_release_tpu_torch.tools.tpurun",
             "-n", "2", sys.executable, "-c", code],
            capture_output=True, text=True, env=env, timeout=180)
        assert r.returncode == 0, r.stderr
        passes = [int(line.split("ring complete here: ")[1].split()[0])
                  for line in r.stdout.splitlines()
                  if "ring complete here" in line]
        assert sum(passes) == 7 + 3 * 8, r.stdout
        assert "rank 0: 0 laps to go" in r.stdout

    def test_cli_errors(self):
        from ompi_release_tpu_torch.tools.tpurun import main

        with pytest.raises(SystemExit):
            main(["-n", "2"])  # no command
        with pytest.raises(SystemExit):
            main(["-n", "0", "true"])


class TestMultiHost:
    def test_hostfile_and_map_policies(self, tmp_path):
        hf = tmp_path / "hosts"
        hf.write_text("# allocation\nnodeA slots=2\nnodeB slots=3\n")
        hosts = parse_hostfile(str(hf))
        assert [(h.name, h.slots) for h in hosts] == [
            ("nodeA", 2), ("nodeB", 3)]
        assert [(h.name, h.slots) for h in parse_host_list("x:2,y")] == [
            ("x", 2), ("y", 1)]
        assert [h.name for h in map_ranks(hosts, 4, "slot")] == [
            "nodeA", "nodeA", "nodeB", "nodeB"]
        assert [h.name for h in map_ranks(hosts, 4, "node")] == [
            "nodeA", "nodeB", "nodeA", "nodeB"]
        assert [h.name for h in map_ranks(hosts, 5, "node")] == [
            "nodeA", "nodeB", "nodeA", "nodeB", "nodeB"]
        with pytest.raises(MPIError):
            map_ranks(hosts, 6, "slot")

    def test_mappers_agree_with_the_jax_launcher(self, tmp_path):
        hf = tmp_path / "hosts"
        hf.write_text("nodeA slots=4\nnodeB slots=4\nnodeC slots=4\n")
        for n, policy in ((5, "slot"), (7, "node"), (5, "ppr:2:node"),
                          (6, "ppr:2:node")):
            ours = [h.name for h in map_ranks(parse_hostfile(str(hf)), n,
                                              policy)]
            theirs = [h.name for h in jtpurun.map_ranks(
                jtpurun.parse_hostfile(str(hf)), n, policy)]
            assert ours == theirs, (n, policy)

    def test_ppr_and_seq_mappers(self, tmp_path):
        hf = tmp_path / "hosts"
        hf.write_text("nodeA slots=4\nnodeB slots=4\nnodeC slots=4\n")
        hosts = parse_hostfile(str(hf))
        assert [h.name for h in map_ranks(hosts, 5, "ppr:2:node")] == [
            "nodeA", "nodeA", "nodeB", "nodeB", "nodeC"]
        with pytest.raises(MPIError, match="places only"):
            map_ranks(hosts, 7, "ppr:2:node")
        with pytest.raises(MPIError, match="exceeds"):
            map_ranks(hosts, 4, "ppr:5:node")
        with pytest.raises(MPIError, match="ppr"):
            map_ranks(hosts, 2, "ppr:2:socket")
        sf = tmp_path / "seqhosts"
        sf.write_text("nodeB\nnodeA\nnodeB\n")
        seq_hosts = parse_hostfile(str(sf))
        assert [h.name for h in map_ranks(seq_hosts, 3, "seq")] == [
            "nodeB", "nodeA", "nodeB"]
        with pytest.raises(MPIError, match="allocation lines"):
            map_ranks(seq_hosts, 4, "seq")

    def test_rankfile_mapping(self, tmp_path):
        alloc = [HostSpec("nodeA", 2), HostSpec("nodeB", 2)]
        rf = tmp_path / "ranks"
        rf.write_text("# explicit placement\nrank 0=nodeB slot=0\n"
                      "rank 2=nodeA\nrank 1=nodeB slot=1\n")
        assert [h.name for h in parse_rankfile(str(rf), 3, alloc)] == [
            "nodeB", "nodeB", "nodeA"]
        job = Job(3, ["true"], [], hosts=alloc, map_by="slot",
                  rankfile=str(rf))
        assert [h.name for h in job.rank_hosts] == [
            "nodeB", "nodeB", "nodeA"]
        for text, match in (
                ("rank 0=nodeA\n", "unmapped"),
                ("rank 0=nodeA\nrank 0=nodeB\nrank 1=nodeA\n", "twice"),
                ("rank 0=nodeZ\nrank 1=nodeA\n", "not in"),
                ("rank 0=nodeA slot=7\nrank 1=nodeB\n", "slot 7"),
                ("banana\n", "unparseable")):
            rf.write_text(text)
            n = 1 if text == "banana\n" else 2
            with pytest.raises(MPIError, match=match):
                parse_rankfile(str(rf), n, alloc)
        rf.write_text("rank 0=nodeA\nrank 1=nodeA\nrank 2=nodeA\n")
        with pytest.raises(MPIError, match="exceed"):
            parse_rankfile(str(rf), 3, alloc)
        rf.write_text("rank 0=alpha\nrank 1=alpha\n")
        job2 = Job(2, ["true"], [], rankfile=str(rf))
        assert [(h.name, h.slots) for h in job2.hosts] == [("alpha", 2)]
        assert all(h is job2.hosts[0] for h in job2.rank_hosts)

    def test_fake_ssh_two_host_job(self, tmp_path, capfd):
        log = tmp_path / "ssh_targets.log"
        agent = tmp_path / "fakessh"
        agent.write_text("#!/bin/sh\n"
                         f'echo "$1" >> {log}\n'
                         "shift\n"
                         'exec sh -c "$*"\n')
        agent.chmod(0o755)
        app = _write_app(tmp_path, """
            world = init()
            pi = Runtime.current().bootstrap["process_index"]
            print(f"host={os.environ['OMPITPU_HOST']} rank={pi}")
            print("mca=" + os.environ["OMPITPU_MCA_quoting_probe"])
            mpi.finalize()
        """)
        job = Job(4, [sys.executable, app],
                  [("quoting_probe", "two words; $(rm -rf /) `x`")],
                  heartbeat_s=0.3,
                  hosts=[HostSpec("nodeA", 2), HostSpec("nodeB", 2)],
                  launch_agent=str(agent))
        rc = job.run(timeout_s=120)
        out = capfd.readouterr().out
        assert rc == 0, out
        assert sorted(log.read_text().split()) == [
            "nodeA", "nodeA", "nodeB", "nodeB"]
        assert "host=nodeA rank=0" in out and "host=nodeB rank=2" in out
        assert out.count("mca=two words; $(rm -rf /) `x`") == 4
        assert job.job_state.visited(JobState.TERMINATED)

    def test_nonloopback_wireup_and_card_addresses(self):
        from ompi_release_tpu_torch.runtime.coordinator import (
            HnpCoordinator, WorkerAgent, local_addr_toward)

        ip = local_addr_toward("192.0.2.1")  # TEST-NET: no packet sent
        if ip.startswith("127."):
            pytest.skip("no non-loopback interface available")
        hnp = HnpCoordinator(2, bind_addr="0.0.0.0")
        agent = None
        try:
            t = threading.Thread(target=lambda: hnp.run_modex(None))
            t.start()
            agent = WorkerAgent(1, ip, hnp.port)
            worker_cards = agent.run_modex({"pid": os.getpid()})
            t.join(timeout=10)
            assert worker_cards[0]["oob_host"] == ip
        finally:
            if agent is not None:
                agent.close()
            hnp.shutdown()
