"""The port's dynamic processes (``comm/dpm.py``, ``comm/spawn.py``) held
against the JAX package.

In one process, the dpm cases of ``tests/test_intercomm.py``
(``:146-184``, ``:318-343``) run on both packages: connect/accept
through a published name forming an intercommunicator whose
inter-allgather is bitwise the JAX package's, an unknown port and an
accept timeout, a duplicate publish, a port reused across accepts, and a
lookup of a published port after ``close_port`` (``ERR_PROC_FAILED`` in
both). ``TestCommSpawn`` (``tests/test_tpurun.py:689``) runs through the
port's ``comm_spawn`` with the reference's child app and closed forms.

Under tpurun (2 workers x 4 ranks, the harness of
``tests/test_torch_unified_world.py``): the name service is job-global
in both packages, and a lookup of a closed port raises ``ERR_PROC_FAILED``
in every worker of the port (the JAX package's job table tracks no port
liveness: its lookup returns the dead port). The port's rendezvous
crosses processes: worker 1's local comm connects to worker 0's, the
intercommunicator carries a send and an allreduce over its merge, each
bitwise ``intercomm_create``'s over the same groups; the JAX package's
rendezvous is process-local, so the same connect raises ``ERR_PORT``.
A third job, the port's alone (3 workers x 2 ranks), shows that a pair
only some workers build leaves every worker's later comms with the same
cids.
"""

import sys
import textwrap
import threading

import numpy as np
import pytest

import ompi_release_tpu as jmpi
from ompi_release_tpu.comm import dpm as jdpm
from ompi_release_tpu.mca import var as jvar
from ompi_release_tpu.utils.errors import ErrorCode as JErrorCode
from ompi_release_tpu.utils.errors import MPIError as JMPIError
import ompi_release_tpu_torch as tmpi
from ompi_release_tpu_torch.comm import dpm as tdpm
from ompi_release_tpu_torch.comm import comm_spawn
from ompi_release_tpu_torch.mca import var as tvar
from ompi_release_tpu_torch.runtime import runtime as trt
from ompi_release_tpu_torch.utils.errors import ErrorCode, MPIError

from test_torch_unified_world import REPO, _parity

N = 8


@pytest.fixture(scope="module")
def worlds():
    jworld = jmpi.init()
    trt._reset_for_tests()
    tworld = tmpi.init(cli_args=["--mca", "runtime_virtual_ranks", str(N)],
                       device="cpu")
    jvar.set_value("coll", "tuned")
    tvar.set_value("coll", "tuned")
    yield jworld, tworld
    jvar.VARS.unset("coll")
    tvar.VARS.unset("coll")
    trt._reset_for_tests()
    tvar.VARS.unset("runtime_virtual_ranks")


PKGS = {"jax": (0, jdpm, JMPIError), "torch": (1, tdpm, MPIError)}


@pytest.fixture(params=list(PKGS))
def pkg(request, worlds):
    i, mod, err = PKGS[request.param]
    return request.param, worlds[i], mod, err


def _pair(w):
    return (w.create(w.group.incl([0, 1, 2]), name="A"),
            w.create(w.group.incl([3, 4, 5, 6, 7]), name="B"))


def _connect_accept(w, dpm, svc):
    a, b = _pair(w)
    port = dpm.open_port()
    dpm.publish_name(svc, port)
    results = {}

    def server():
        results["server"] = dpm.comm_accept(a, port, timeout_s=15)

    t = threading.Thread(target=server)
    t.start()
    found = dpm.lookup_name(svc, timeout_s=15)
    assert found == port
    client = dpm.comm_connect(b, found, timeout_s=15)
    t.join(timeout=15)
    return port, results["server"], client


def test_connect_accept_forms_intercomm(pkg):
    name, w, dpm, err = pkg
    port, server, client = _connect_accept(w, dpm, f"ocean-{name}")
    assert server.group.world_ranks == (0, 1, 2)
    assert server.remote_group.world_ranks == (3, 4, 5, 6, 7)
    assert client.group.world_ranks == (3, 4, 5, 6, 7)
    assert client.mirror is server
    bufs_a = np.arange(3, dtype=np.float32).reshape(3, 1)
    bufs_b = 50 + np.arange(5, dtype=np.float32).reshape(5, 1)
    got = np.asarray(server.allgather(bufs_a, bufs_b)).ravel()
    np.testing.assert_array_equal(got, bufs_b.ravel())
    dpm.unpublish_name(f"ocean-{name}")
    with pytest.raises(err):
        dpm.lookup_name(f"ocean-{name}", timeout_s=0.1)
    dpm.close_port(port)


def test_inter_allreduce_bitwise_across_packages(worlds):
    outs = []
    for name, (i, dpm, _) in PKGS.items():
        port, server, client = _connect_accept(worlds[i], dpm,
                                               f"bitwise-{name}")
        rng = np.random.default_rng(3)
        a = rng.standard_normal((3, 4)).astype(np.float32)
        b = rng.standard_normal((5, 4)).astype(np.float32)
        got = client.allreduce(b, a)
        outs.append(np.asarray(got.numpy() if hasattr(got, "numpy")
                               else got))
        dpm.unpublish_name(f"bitwise-{name}")
        dpm.close_port(port)
    assert outs[0].tobytes() == outs[1].tobytes()


def test_connect_unknown_port_and_timeout(pkg):
    _, w, dpm, err = pkg
    a, _ = _pair(w)
    with pytest.raises(err):
        dpm.comm_connect(a, "tpu-port:99999", timeout_s=0.2)
    port = dpm.open_port()
    with pytest.raises(err):
        dpm.comm_accept(a, port, timeout_s=0.2)  # nobody connects
    dpm.close_port(port)


def test_publish_duplicate_rejected(pkg):
    name, _, dpm, err = pkg
    port = dpm.open_port()
    dpm.publish_name(f"dup-{name}", port)
    with pytest.raises(err):
        dpm.publish_name(f"dup-{name}", port)
    dpm.unpublish_name(f"dup-{name}")
    with pytest.raises(err):
        dpm.unpublish_name(f"dup-{name}")
    dpm.close_port(port)


def test_port_reusable_across_accepts(pkg):
    _, w, dpm, err = pkg
    srv = w.create(w.group.incl([0, 1]), name="srv")
    c1 = w.create(w.group.incl([2, 3]), name="c1")
    c2 = w.create(w.group.incl([4, 5]), name="c2")
    port = dpm.open_port()
    results = []

    def serve():
        for _ in range(2):
            results.append(dpm.comm_accept(srv, port, timeout_s=15))

    t = threading.Thread(target=serve)
    t.start()
    ic1 = dpm.comm_connect(c1, port, timeout_s=15)
    ic2 = dpm.comm_connect(c2, port, timeout_s=15)
    t.join(timeout=20)
    assert len(results) == 2
    assert results[0].remote_group.world_ranks == (2, 3)
    assert results[1].remote_group.world_ranks == (4, 5)
    assert ic1.remote_group.world_ranks == (0, 1)
    assert ic2.remote_group.world_ranks == (0, 1)
    dpm.close_port(port)
    with pytest.raises(err):
        dpm.comm_connect(c1, port, timeout_s=0.2)


def test_lookup_of_closed_port_raises_proc_failed(pkg):
    """The reference's singleton lookup (``comm/dpm.py:311-320``): a
    published name that points at a closed ``tpu-port:`` is a dead name,
    not an opaque value."""
    name, _, dpm, err = pkg
    port = dpm.open_port()
    dpm.publish_name(f"gone-{name}", port)
    assert dpm.lookup_name(f"gone-{name}", timeout_s=1) == port
    dpm.close_port(port)
    with pytest.raises(err) as ei:
        dpm.lookup_name(f"gone-{name}", timeout_s=1)
    assert int(ei.value.code) == int(JErrorCode.ERR_PROC_FAILED)
    dpm.unpublish_name(f"gone-{name}")


def test_dpm_reexports_the_one_name_table():
    """One name table (the name service's); dpm's lookup is that
    lookup plus the port check, and ``comm`` exports dpm's."""
    from ompi_release_tpu_torch.comm import lookup_name
    from ompi_release_tpu_torch.runtime import pubsub

    assert tdpm.publish_name is pubsub.publish_name
    assert tdpm.unpublish_name is pubsub.unpublish_name
    assert lookup_name is tdpm.lookup_name
    assert not hasattr(tdpm, "_names")
    port = tdpm.open_port()
    pubsub.publish_name("raw-lookup", port)
    tdpm.close_port(port)
    # the raw table lookup hands the dead port through; dpm's refuses it
    assert pubsub.lookup_name("raw-lookup", timeout_s=1) == port
    with pytest.raises(MPIError) as ei:
        tdpm.lookup_name("raw-lookup", timeout_s=1)
    assert ei.value.code is ErrorCode.ERR_PROC_FAILED
    pubsub.unpublish_name("raw-lookup")


# ---------------------------------------------------------------------------
# TestCommSpawn (tests/test_tpurun.py:689) through the port
# ---------------------------------------------------------------------------

SPAWN_PRELUDE = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, %r)
    import ompi_release_tpu_torch as mpi
    from ompi_release_tpu_torch.runtime.runtime import Runtime
""" % REPO)


def _child(tmp_path, body):
    p = tmp_path / "child.py"
    p.write_text(SPAWN_PRELUDE + textwrap.dedent(body))
    return str(p)


class TestCommSpawn:
    def test_spawn_exchange_and_wait(self, tmp_path):
        app = _child(tmp_path, """
            world = mpi.init(device="cpu")
            rt = Runtime.current()
            pi = rt.bootstrap["process_index"]
            src, tag, payload = rt.agent.ep.recv(tag=101,
                                                 timeout_ms=30000)
            rt.agent.ep.send(0, 102, payload + f"+child{pi}".encode())
            mpi.finalize()
        """)
        job = comm_spawn([sys.executable, app], 2, timeout_s=120)
        assert job.remote_size == 2
        job.wait_running(timeout_s=60)
        job.send(0, 101, b"hello")
        job.send(1, 101, b"hello")
        replies = {}
        for _ in range(2):
            rank, payload = job.recv(102, timeout_ms=30000)
            replies[rank] = payload
        assert replies == {0: b"hello+child0", 1: b"hello+child1"}
        assert job.wait(timeout_s=60) == 0
        with pytest.raises(MPIError):
            job.send(5, 101, b"x")
        with pytest.raises(MPIError):
            job.send(0, 3, b"x")  # control-plane tags protected

    def test_messaging_after_job_end_errors_cleanly(self, tmp_path):
        app = _child(tmp_path, """
            world = mpi.init(device="cpu")
            mpi.finalize()
        """)
        job = comm_spawn([sys.executable, app], 1, timeout_s=120)
        assert job.wait(timeout_s=60) == 0
        with pytest.raises(MPIError) as ei:
            job.send(0, 101, b"late")
        assert ei.value.code is ErrorCode.ERR_SPAWN
        with pytest.raises(MPIError):
            job.recv(102, timeout_ms=100)


# ---------------------------------------------------------------------------
# under tpurun: the job-global name table, closed ports, and the port's
# cross-process rendezvous
# ---------------------------------------------------------------------------

JOB_BODY = """
import importlib
OUT = {}
MOD = "ompi_release_tpu" if PKG == "jax" else "ompi_release_tpu_torch"
dpm = importlib.import_module(MOD + ".comm.dpm")
icm = importlib.import_module(MOD + ".comm.intercomm")
world = init()
rt = Runtime.current()
off = rt.local_rank_offset
me = rt.bootstrap["process_index"]
subs = world.split([0] * 4 + [1] * 4)
mine = subs[off]
if me == 0:
    port = dpm.open_port()
    dpm.publish_name("svc-live", port)
    dead = dpm.open_port()
    dpm.publish_name("svc-dead", dead)
    dpm.close_port(dead)
world.barrier()
port = dpm.lookup_name("svc-live", timeout_s=30)
try:
    dpm.lookup_name("svc-dead", timeout_s=5)
    OUT["dead_lookup"] = np.int32(0)
except MPIError as e:
    OUT["dead_lookup"] = np.int32(int(e.code))
world.barrier()
if PKG == "torch":
    if me == 0:
        inter = dpm.comm_accept(mine, port, timeout_s=60)
    else:
        inter = dpm.comm_connect(mine, port, timeout_s=60)
else:
    if me == 1:
        try:
            dpm.comm_connect(mine, port, timeout_s=5)
            OUT["connect_error"] = np.int32(0)
        except MPIError as e:
            OUT["connect_error"] = np.int32(int(e.code))
    world.barrier()
    inter = icm.intercomm_create(subs[0], 0, subs[4], 0)[me]
assert inter.remote_size == 4
if me == 0:
    inter.send(np.int32([41]), dest=2, tag=3, rank=1)
    val, st = inter.recv(source=2, tag=4, rank=1)
else:
    val, st = inter.recv(source=1, tag=3, rank=2)
    inter.send(np.int32([42]), dest=1, tag=4, rank=2)
OUT["inter_recv"] = npy(val)
OUT["inter_source"] = np.int32(st.source)
merged = inter.merge(high=(me == 1))
x = np.stack([np.float32([off + i, 1.5 * (off + i)]) for i in range(4)])
OUT["inter_merged_allreduce"] = npy(merged.allreduce(x))
world.barrier()
if me == 0:
    dpm.close_port(port)
world.barrier()
try:
    dpm.lookup_name("svc-live", timeout_s=5)
    OUT["closed_lookup"] = np.int32(0)
except MPIError as e:
    OUT["closed_lookup"] = np.int32(int(e.code))
world.barrier()
mpi.finalize()
"""


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    return _parity(tmp_path_factory, JOB_BODY, "dpm_job")


def test_rendezvous_across_processes_matches_intercomm_create(job):
    """The port's cross-process accept/connect forms the intercomm that
    ``intercomm_create`` forms over the same groups: its send and its
    merged allreduce are bitwise the JAX package's."""
    for p in range(2):
        jd, td = job["jax"][p], job["torch"][p]
        for k in ("inter_recv", "inter_source", "inter_merged_allreduce"):
            assert jd[k].tobytes() == td[k].tobytes(), (p, k)
    assert int(job["torch"][1]["inter_source"]) == 1
    assert int(job["torch"][0]["inter_recv"][0]) == 42


def test_jax_rendezvous_is_process_local(job):
    assert int(job["jax"][1]["connect_error"]) == int(JErrorCode.ERR_PORT)


def test_closed_port_lookup_raises_proc_failed_in_every_worker(job):
    """In the port a closed port is a dead name in every worker (the
    closing worker's table and the job-global tombstone); the JAX
    package's job table tracks no port liveness."""
    failed = int(JErrorCode.ERR_PROC_FAILED)
    for p in range(2):
        assert int(job["torch"][p]["dead_lookup"]) == failed
        assert int(job["torch"][p]["closed_lookup"]) == failed
        assert int(job["jax"][p]["dead_lookup"]) == 0


# ---------------------------------------------------------------------------
# a pair exists only in the processes taking part: its cids come from a
# block of their own, and the other workers' comms keep agreeing
# ---------------------------------------------------------------------------

THREE_WORKER_BODY = """
import json, threading
from ompi_release_tpu_torch.comm import UNDEFINED, dpm
world = init()
rt = Runtime.current()
off = rt.local_rank_offset
me = rt.bootstrap["process_index"]
locals_ = world.split([r // 2 for r in range(6)])
mine = locals_[off]
halves = world.split([UNDEFINED] * 4 + [0, 1])
if me == 0:
    dpm.publish_name("p3-svc", dpm.open_port())
world.barrier()
rec = {}
if me in (0, 1):
    port = dpm.lookup_name("p3-svc", timeout_s=30)
    inter = (dpm.comm_accept(mine, port, timeout_s=60) if me == 0
             else dpm.comm_connect(mine, port, timeout_s=60))
    merged = inter.merge(high=(me == 1))
    x = np.stack([np.float32([off + i]) for i in range(2)])
    got = npy(merged.allreduce(x))
    assert got.ravel().tolist() == [6.0, 6.0], got
    rec["pair"] = [inter.cid, inter._bridge.cid, inter.mirror.cid,
                   merged.cid]
else:
    # a worker-local pair: both sides in this worker
    port = dpm.open_port()
    box = {}
    t = threading.Thread(target=lambda: box.update(
        a=dpm.comm_accept(halves[4], port, timeout_s=60)))
    t.start()
    client = dpm.comm_connect(halves[5], port, timeout_s=60)
    t.join(60)
    assert box["a"].remote_size == 1 and client.remote_size == 1
    rec["local_pair"] = [box["a"].cid, client.cid]
world.barrier()
# every worker: a collective over comms created after the pairs
split = world.split([r % 2 for r in range(6)])
res = {}
for c in (split[0], split[1]):
    buf = np.stack([np.float32([c.group.world_rank(i)])
                    for i in c.local_comm_ranks])
    res[str(c.cid)] = npy(c.allreduce(buf)).ravel().tolist()
rec["split"] = res
print("P3=" + json.dumps({"me": me, **rec}), flush=True)
world.barrier()
mpi.finalize()
"""


def test_pairs_leave_the_other_workers_cids_agreeing(tmp_path, capfd):
    """Three workers: 0 and 1 connect across processes and merge, 2
    pairs two of its own comms; then every worker splits the world and
    allreduces over comms that span all three. The split's cids agree
    on every worker (else the wire, which keys collective channels by
    cid, would hang or cross two comms' frames), the pair's cids agree
    between its two workers, and no pair drew a cid below the band."""
    import json

    from ompi_release_tpu_torch.comm.communicator import CID_BAND
    from test_torch_unified_world import _port_job

    out = _port_job(tmp_path, capfd, THREE_WORKER_BODY, n=3, nvirt=2)
    recs = {}
    for line in out.splitlines():
        if "P3=" in line:
            r = json.loads(line.split("P3=", 1)[1])
            recs[r["me"]] = r
    assert sorted(recs) == [0, 1, 2]
    splits = [recs[p]["split"] for p in range(3)]
    assert splits[0] == splits[1] == splits[2]
    assert sorted(v[0] for v in splits[0].values()) == [6.0, 9.0]
    # (this side, bridge, mirror, merge): worker 1 holds the other side
    a, bridge, b, merged = recs[0]["pair"]
    assert recs[1]["pair"] == [b, bridge, a, merged]
    assert min(recs[0]["pair"]) >= CID_BAND
    assert min(recs[2]["local_pair"]) >= CID_BAND
    assert not set(recs[0]["pair"]) & set(recs[2]["local_pair"])
