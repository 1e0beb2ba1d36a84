"""The port's ``distributed`` ESS (``ompi_release_tpu_torch/runtime/ess.py``)
held against ``tests/test_ess_distributed.py`` and the JAX component.

The JAX package's test of this component skips on a box whose jaxlib
has no cross-process CPU collectives, so the reference's results cannot
be called here. The port is held against two references instead:

- the JAX ``DistributedEss`` itself, for its name, priority, variables
  and selection (``ompi_release_tpu.runtime.ess`` is import-light; its
  ``bootstrap`` is never called);
- the port's ``tpurun`` world of the same shape, bitwise: two OS
  processes started by hand with the env contract (4 CPU virtual ranks
  each) form one 8-rank COMM_WORLD whose allreduce equals the same
  ``tools.tpurun -n 2`` job's.

Also: a process that finds no coordinator, an unset process id and a
wrong process count raise typed errors within their deadlines; a clean
finalize leaves no shm ring or segment of either pid; the
``unified_world_tpu`` example runs under the distributed bootstrap.
"""

import glob
import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the environment contract of both packages' distributed ESS
DIST_VARS = ("OMPITPU_COORDINATOR", "OMPITPU_PROCESS_ID",
             "OMPITPU_NUM_PROCESSES")
LAUNCH_VARS = DIST_VARS + ("OMPITPU_HNP", "OMPITPU_NODE_ID",
                           "OMPITPU_NUM_NODES", "OMPITPU_JOB_SECRET")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _base_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in LAUNCH_VARS and k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


def _leftovers(pids):
    """Shm segments, nativewire rings and event rings of ``pids``."""
    return [f for pid in pids
            for pat in (f"ompitpu-{pid}-*", f"onw-{pid:x}-*",
                        f"onwev-{pid:x}-*")
            for f in glob.glob(os.path.join("/dev/shm", pat))]


def _start(code_or_path, env, args=()):
    cmd = ([sys.executable, str(code_or_path)] if os.path.exists(
        str(code_or_path)) else [sys.executable, "-c", code_or_path])
    return subprocess.Popen(cmd + list(args), cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _run_pair(code_or_path, env_of, timeout=120):
    """Start one process per id with ``env_of(pid)``; wait for both
    within ``timeout``. Returns [(rc, out, err, os pid)]."""
    procs = [_start(code_or_path, env_of(pid)) for pid in range(2)]
    res = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            res.append((p.returncode, out, err, p.pid))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return res


def _dist_env(port, pid, nprocs=2, **extra):
    return _base_env(OMPITPU_COORDINATOR=f"127.0.0.1:{port}",
                     OMPITPU_PROCESS_ID=str(pid),
                     OMPITPU_NUM_PROCESSES=str(nprocs), **extra)


# ---------------------------------------------------------------------------
# the component against the JAX package's
# ---------------------------------------------------------------------------

_PARITY = textwrap.dedent("""
    import json
    from ompi_release_tpu.mca import var as jvar
    from ompi_release_tpu.runtime import ess as jess
    from ompi_release_tpu_torch.mca import var as tvar
    from ompi_release_tpu_torch.runtime import ess as tess

    out = {}
    for name, ess, var in (("jax", jess, jvar), ("torch", tess, tvar)):
        fw = ess.ESS_FRAMEWORK
        fw.open()
        comp = ess.DistributedEss
        vars_ = {}
        for v in ("ess_distributed_coordinator",
                  "ess_distributed_process_id",
                  "ess_distributed_num_processes"):
            got = var.VARS.lookup(v)
            vars_[v] = [got.vtype, got.default, var.get(v)]
        mine = fw.lookup("distributed")
        q = mine.query()
        out[name] = {
            "components": sorted(c.NAME for c in fw.components()),
            "name": comp.NAME, "priority": comp.PRIORITY,
            "vars": vars_,
            "query": None if q is None else q[0],
            "selected": fw.select().NAME,
        }
    print(json.dumps(out))
""")


@pytest.mark.parametrize("case,env,selected", [
    ("no coordinator", {}, "singleton"),
    ("coordinator", {"OMPITPU_COORDINATOR": "10.0.0.7:5123",
                     "OMPITPU_PROCESS_ID": "3",
                     "OMPITPU_NUM_PROCESSES": "4"}, "distributed"),
    ("coordinator and tpurun", {"OMPITPU_COORDINATOR": "127.0.0.1:9",
                                "OMPITPU_HNP": "127.0.0.1:10"}, "tpurun"),
])
def test_component_matches_the_jax_package(case, env, selected):
    """Under the same environment both ``DistributedEss`` components
    have the same name and priority, register the same three variables
    with the same types, env-derived defaults and values, and answer
    ``query`` the same way; the framework selects the same component
    (tpurun's 60 beats distributed's 50 when both environments are
    present)."""
    r = subprocess.run([sys.executable, "-c", _PARITY], cwd=REPO,
                       env=_base_env(**env), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    doc = json.loads(r.stdout.strip().splitlines()[-1])
    jax, tor = doc["jax"], doc["torch"]
    assert tor["components"] == jax["components"] \
        == ["distributed", "singleton", "tpurun"]
    for key in ("name", "priority", "vars", "query", "selected"):
        assert tor[key] == jax[key], (case, key, tor[key], jax[key])
    assert tor["name"] == "distributed" and tor["priority"] == 50
    assert tor["selected"] == selected
    assert (tor["query"] is None) == ("OMPITPU_COORDINATOR" not in env)
    vars_ = tor["vars"]
    assert vars_["ess_distributed_coordinator"][0] == "str"
    assert vars_["ess_distributed_process_id"][:2] == [
        "int", int(env.get("OMPITPU_PROCESS_ID", "-1"))]
    assert vars_["ess_distributed_num_processes"][:2] == [
        "int", int(env.get("OMPITPU_NUM_PROCESSES", "0"))]


# ---------------------------------------------------------------------------
# two hand-started processes form one world
# ---------------------------------------------------------------------------

#: one app body for both bootstraps; EXPECT_ESS names the component the
#: framework must pick, OUT_DIR receives each process's npz dump
WORKER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, %(repo)r)
    import numpy as np
    import ompi_release_tpu_torch as mpi
    from ompi_release_tpu_torch.coll import plan as cplan
    from ompi_release_tpu_torch.runtime import ess as ess_mod
    from ompi_release_tpu_torch.runtime.runtime import Runtime

    sel = ess_mod.ESS_FRAMEWORK.select()
    assert sel.NAME == os.environ["EXPECT_ESS"], sel.NAME
    world = mpi.init(cli_args=["--mca", "runtime_virtual_ranks", "4",
                               "--mca", "coll", "tuned,basic,self,hier"],
                     device="cpu")
    rt = Runtime.current()
    pid = rt.bootstrap["process_index"]
    assert rt.bootstrap["process_count"] == 2
    assert world.size == 8, world.size  # 2 processes x 4 ranks
    assert world.spans_processes
    owners = sorted({e.process_index for e in rt.endpoints})
    assert owners == [0, 1], owners
    off = rt.local_rank_offset
    assert (off, rt.local_size) == (4 * pid, 4)

    # int32: the test's own closed form, and the second call replays
    x = np.stack([np.arange(8, dtype=np.int32) + r
                  for r in range(off, off + 4)])
    want = sum(np.arange(8, dtype=np.int32) + r for r in range(8))
    out = world.allreduce(x).numpy()
    assert out.shape == (4, 8), out.shape
    for row in out:
        np.testing.assert_array_equal(row, want)
    n0 = len(cplan._span_states)
    out2 = world.allreduce(2 * x).numpy()
    np.testing.assert_array_equal(out2[0], 2 * want)
    assert len(cplan._span_states) == n0, "the second call re-recorded"
    assert all(st.last != "interpreted"
               for st in cplan._span_states.values()), \\
        [st.last for st in cplan._span_states.values()]

    # f32 of seeded inputs: dumped, compared across bootstraps bitwise
    dump = {}
    for count in (1000, 300_000):
        full = np.random.default_rng(count).normal(
            size=(8, count)).astype(np.float32)
        dump[f"allreduce_{count}"] = world.allreduce(
            full[off:off + 4]).numpy()
    np.savez(os.path.join(os.environ["OUT_DIR"],
                          f"{sel.NAME}-p{pid}.npz"), **dump)

    # p2p across the process boundary, rank 0 -> rank 7
    if pid == 0:
        world.send(np.arange(5, dtype=np.float32), 7, tag=12, rank=0)
    else:
        v, st = world.recv(source=0, tag=12, rank=7)
        np.testing.assert_array_equal(v.numpy(),
                                      np.arange(5, dtype=np.float32))
        assert st.source == 0
    print(f"DIST-OK {pid} {sel.NAME}", flush=True)
    mpi.finalize()
    print(f"FINALIZED {pid}", flush=True)
""")


def test_two_hand_started_processes_form_one_world(tmp_path):
    """Two processes started by hand with the env contract select
    ``distributed``, form one 8-rank world (owners [0, 1]) whose int32
    allreduce equals its closed form and replays its plan, whose f32
    allreduces are bitwise the same ``tools.tpurun -n 2`` job's, and
    whose p2p crosses the boundary; both finalize, exit 0 and leave no
    ring or segment of their pids behind."""
    app = tmp_path / "dist_worker.py"
    app.write_text(WORKER % {"repo": REPO})
    port = _free_port()
    res = _run_pair(app, lambda pid: _dist_env(
        port, pid, EXPECT_ESS="distributed", OUT_DIR=str(tmp_path)))
    for pid, (rc, out, err, _) in enumerate(res):
        assert rc == 0, f"process {pid}:\n{err[-3000:]}"
        assert f"DIST-OK {pid} distributed" in out
        assert f"FINALIZED {pid}" in out
    assert not _leftovers([r[3] for r in res])

    r = subprocess.run(
        [sys.executable, "-m", "ompi_release_tpu_torch.tools.tpurun",
         "-n", "2", sys.executable, str(app)], cwd=REPO,
        env=_base_env(EXPECT_ESS="tpurun", OUT_DIR=str(tmp_path)),
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:] + r.stdout[-3000:]
    for pid in range(2):
        dist = np.load(tmp_path / f"distributed-p{pid}.npz")
        tpr = np.load(tmp_path / f"tpurun-p{pid}.npz")
        assert sorted(dist.files) == sorted(tpr.files) == [
            "allreduce_1000", "allreduce_300000"]
        for key in dist.files:
            assert dist[key].dtype == np.float32
            assert dist[key].tobytes() == tpr[key].tobytes(), (pid, key)
            full = np.random.default_rng(int(key.split("_")[1])).normal(
                size=(8, int(key.split("_")[1]))).astype(np.float32)
            np.testing.assert_allclose(dist[key][0], full.sum(0),
                                       rtol=1e-5, atol=1e-5)


def test_process_zero_may_start_last(tmp_path):
    """Process 1 comes up before process 0 listens: its dial is retried
    until the coordinator is there, and the job completes."""
    app = tmp_path / "dist_worker.py"
    app.write_text(WORKER % {"repo": REPO})
    port = _free_port()
    late = _start(app, _dist_env(port, 1, EXPECT_ESS="distributed",
                                 OUT_DIR=str(tmp_path)))
    try:
        time.sleep(3.0)
        assert late.poll() is None, late.communicate()[1][-3000:]
        first = _start(app, _dist_env(port, 0, EXPECT_ESS="distributed",
                                      OUT_DIR=str(tmp_path)))
        try:
            outs = [p.communicate(timeout=120) for p in (first, late)]
        finally:
            if first.poll() is None:
                first.kill()
    finally:
        if late.poll() is None:
            late.kill()
    assert first.returncode == 0, outs[0][1][-3000:]
    assert late.returncode == 0, outs[1][1][-3000:]
    assert not _leftovers([first.pid, late.pid])


# ---------------------------------------------------------------------------
# failure paths: typed errors within their deadlines, never a hang
# ---------------------------------------------------------------------------

_INIT_ONLY = textwrap.dedent("""
    import sys, time
    import ompi_release_tpu_torch as mpi
    from ompi_release_tpu_torch.utils.errors import MPIError
    t0 = time.monotonic()
    try:
        mpi.init(cli_args=["--mca", "runtime_virtual_ranks", "4"],
                 device="cpu")
    except MPIError as e:
        print("RAISED", e.code.name, round(time.monotonic() - t0, 2),
              str(e).replace("\\n", " "), flush=True)
        sys.exit(3)
    print("INIT-RETURNED", flush=True)
""")


def _raised(out):
    line = next(ln for ln in out.splitlines() if ln.startswith("RAISED"))
    _, code, secs, msg = line.split(" ", 3)
    return code, float(secs), msg


def test_no_coordinator_raises_within_the_dial_deadline():
    """Process 1 alone against a port nobody listens on retries its
    dial for the 30 s deadline, then raises naming the address."""
    from ompi_release_tpu_torch.runtime.ess import DistributedEss

    port = _free_port()
    r = subprocess.run([sys.executable, "-c", _INIT_ONLY], cwd=REPO,
                       env=_dist_env(port, 1), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 3, r.stdout + r.stderr[-3000:]
    code, secs, msg = _raised(r.stdout)
    assert code == "ERR_UNREACH"
    assert f"127.0.0.1:{port}" in msg
    deadline = DistributedEss.DIAL_TIMEOUT_S
    assert deadline <= secs < deadline + 15, secs


@pytest.mark.parametrize("unset", ["OMPITPU_PROCESS_ID",
                                   "OMPITPU_NUM_PROCESSES"])
def test_unset_id_or_count_raises_err_arg(unset):
    """The JAX package hands an unset id or count to jax.distributed to
    auto-detect; the port has no cluster to detect, so it raises
    ``ERR_ARG`` naming the variable, before binding anything."""
    env = _dist_env(_free_port(), 0)
    env.pop(unset)
    r = subprocess.run([sys.executable, "-c", _INIT_ONLY], cwd=REPO,
                       env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 3, r.stdout + r.stderr[-3000:]
    code, secs, msg = _raised(r.stdout)
    assert code == "ERR_ARG" and unset in msg
    assert secs < 10


def test_port_taken_raises_a_typed_error():
    """Process 0 cannot host the coordinator on a port another socket
    holds: ``ERR_PORT``, at once."""
    holder = socket.socket()
    holder.bind(("127.0.0.1", 0))
    holder.listen(1)
    try:
        port = holder.getsockname()[1]
        r = subprocess.run([sys.executable, "-c", _INIT_ONLY], cwd=REPO,
                           env=_dist_env(port, 0), capture_output=True,
                           text=True, timeout=120)
    finally:
        holder.close()
    assert r.returncode == 3, r.stdout + r.stderr[-3000:]
    code, secs, msg = _raised(r.stdout)
    assert code == "ERR_PORT" and str(port) in msg
    assert secs < 10


def test_wrong_process_count_ends_in_the_modex_timeout():
    """Both processes are told the job has 3: the modex never
    completes, and each raises its typed timeout instead of hanging."""
    port = _free_port()
    res = _run_pair(_INIT_ONLY, lambda pid: _dist_env(port, pid, 3),
                    timeout=150)
    for rc, out, err, _ in res:
        assert rc == 3, out + err[-3000:]
        _, secs, _ = _raised(out)
        assert secs < 60, secs
    assert not _leftovers([r[3] for r in res])


# ---------------------------------------------------------------------------
# the example
# ---------------------------------------------------------------------------

def test_unified_world_example_under_the_distributed_bootstrap():
    code = ("from ompi_release_tpu_torch.examples import unified_world_tpu"
            " as m\nraise SystemExit(m.main(device='cpu'))\n")
    port = _free_port()
    res = _run_pair(code, lambda pid: _dist_env(port, pid))
    outs = []
    for pid, (rc, out, err, _) in enumerate(res):
        assert rc == 0, f"process {pid}:\n{err[-3000:]}"
        outs.append(out)
    assert "unified world OK (ranks 0..3 of 8)" in outs[0]
    assert "unified world OK (ranks 4..7 of 8)" in outs[1]
    assert not _leftovers([r[3] for r in res])


def test_process_zero_dying_does_not_wait_for_its_peers():
    """Process 0 raises after init while process 1 is still busy: its
    exit stops hosting at once (the launcher's abort policy) instead
    of waiting for a FIN that may never come; it exits 1 within
    seconds, not after its peer."""
    code = textwrap.dedent("""
        import os, time
        import ompi_release_tpu_torch as mpi
        w = mpi.init(cli_args=["--mca", "runtime_virtual_ranks", "2"],
                     device="cpu")
        print("UP", flush=True)
        if os.environ["OMPITPU_PROCESS_ID"] == "0":
            raise RuntimeError("process 0 fails")
        time.sleep(60)
    """)
    port = _free_port()
    procs = [_start(code, _dist_env(port, pid)) for pid in range(2)]
    try:
        t0 = time.monotonic()
        out, err = procs[0].communicate(timeout=45)
        secs = time.monotonic() - t0
        assert procs[0].returncode == 1, err[-3000:]
        assert "UP" in out and "process 0 fails" in err
        assert procs[1].poll() is None  # still asleep: nobody waited
        assert secs < 30, secs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()
