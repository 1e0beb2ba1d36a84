"""The port's unified multi-process COMM_WORLD held against
``tests/test_unified_world.py``: ``tpurun -n 2`` jobs of the port where
each worker owns 4 virtual ranks on the host, so COMM_WORLD spans 8
ranks over 2 OS processes.

Each parity job runs the SAME app body twice — once through the JAX
package's ``Job`` (workers forced to 4 virtual CPU devices) and once
through the port's — and every worker dumps its results to an npz file;
the dumps are compared BITWISE, key by key. The bodies also assert the
reference test's closed forms in-app. Covered: the spanning allreduce
and every other hier collective under each forced inter schedule, the
v-collectives, cross-process send/recv with wildcards, probe and ssend
(the same messages in the same order), ``split_type_shared``, the
inter-byte accounting, three-process cid agreement after a partial
split, the DCN staging path and the unified-world opt-out."""

import os
import sys
import textwrap

import numpy as np
import pytest

from ompi_release_tpu.tools.tpurun import Job as JaxJob
from ompi_release_tpu_torch.runtime.state import JobState
from ompi_release_tpu_torch.tools.tpurun import Job as PortJob

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX_PRELUDE = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, %(repo)r)
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=%(nvirt)d")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import ml_dtypes
    import ompi_release_tpu as mpi
    from ompi_release_tpu import ops
    from ompi_release_tpu.mca import pvar, var as mca_var
    from ompi_release_tpu.runtime.runtime import Runtime
    from ompi_release_tpu.utils.errors import MPIError
    PKG = "jax"

    def init():
        return mpi.init()

    def npy(x):
        a = np.asarray(x)
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a
""")

PORT_PRELUDE = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, %(repo)r)
    import numpy as np
    import ml_dtypes
    import torch
    import ompi_release_tpu_torch as mpi
    from ompi_release_tpu_torch import ops
    from ompi_release_tpu_torch.mca import pvar, var as mca_var
    from ompi_release_tpu_torch.runtime.runtime import Runtime
    from ompi_release_tpu_torch.utils.errors import MPIError
    PKG = "torch"

    def init():
        return mpi.init(cli_args=["--mca", "runtime_virtual_ranks",
                                  "%(nvirt)d"], device="cpu")

    def npy(x):
        t = torch.as_tensor(x).detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
""")

DUMP_EPILOGUE = textwrap.dedent("""
    np.savez(os.path.join(os.environ["PARITY_DUMP"],
                          "%s-%d.npz" % (PKG, Runtime.current()
                                         .bootstrap["process_index"])),
             **OUT)
""")


def _run_job(job_cls, prelude, body, tmp_path, name, n, nvirt, mca=(),
             env=None, timeout=240):
    app = tmp_path / f"{name}.py"
    app.write_text(prelude % {"repo": REPO, "nvirt": nvirt}
                   + textwrap.dedent(body))
    keep = dict(os.environ)
    os.environ.update(env or {})
    try:
        job = job_cls(n, [sys.executable, str(app)], list(mca),
                      heartbeat_s=0.5, miss_limit=16)
        rc = job.run(timeout_s=timeout)
    finally:
        os.environ.clear()
        os.environ.update(keep)
    return rc, job


#: the in-process component both packages' shadow comms select in the
#: parity jobs: the default picks differ (the JAX package's ``xla`` psum
#: folds linearly, the port's ``fused`` pairwise), while ``tuned`` is
#: held bitwise per algorithm by tests/test_torch_coll.py
PARITY_MCA = (("coll", "tuned,basic,self,hier"),)


def _parity(tmp_path_factory, body, name, n=2, nvirt=4, mca=PARITY_MCA):
    """Run ``body`` through both packages' jobs; returns ({key: array}
    per worker for jax, the same for the port)."""
    tmp = tmp_path_factory.mktemp(name)
    dump = tmp / "dump"
    dump.mkdir()
    env = {"PARITY_DUMP": str(dump)}
    full = body + DUMP_EPILOGUE
    rc_j, _ = _run_job(JaxJob, JAX_PRELUDE, full, tmp, "jax_app", n, nvirt,
                       mca, env)
    rc_t, job = _run_job(PortJob, PORT_PRELUDE, full, tmp, "port_app", n,
                         nvirt, mca, env)
    assert rc_j == 0, f"the JAX package's job failed ({rc_j})"
    assert rc_t == 0, f"the port's job failed ({rc_t})"
    assert job.job_state.visited(JobState.TERMINATED)
    out = {}
    for pkg in ("jax", "torch"):
        out[pkg] = [dict(np.load(dump / f"{pkg}-{p}.npz"))
                    for p in range(n)]
    return out


def _assert_bitwise(dumps, prefix=""):
    keys = [k for k in dumps["jax"][0] if k.startswith(prefix)]
    assert keys, f"no results under {prefix!r}"
    for p, (jd, td) in enumerate(zip(dumps["jax"], dumps["torch"])):
        assert sorted(k for k in jd if k.startswith(prefix)) == sorted(
            k for k in td if k.startswith(prefix)), p
        for k in keys:
            a, b = jd[k], td[k]
            assert a.shape == b.shape and a.dtype == b.dtype, (p, k)
            assert a.tobytes() == b.tobytes(), (p, k)


COLL_BODY = """
OUT = {}
world = init()
rt = Runtime.current()
off = rt.local_rank_offset
n = world.size
assert n == 8 and world.spans_processes
assert "hier" in world._coll_providers.get("allreduce", [])

def rows(f):
    return np.stack([f(off + i) for i in range(4)])

# the world-spanning allreduce: same values a single controller reduces
x = rows(lambda r: np.arange(6, dtype=np.float32) * (r + 1) + 0.25 * r)
got = npy(world.allreduce(x))
want = sum(np.arange(6, dtype=np.float32) * (r + 1) + 0.25 * r
           for r in range(n))
np.testing.assert_allclose(got[0], want, rtol=1e-6)
OUT["allreduce_f32"] = got

SCHED = {
    "allreduce": ("linear", "recursive_doubling", "ring", "rabenseifner"),
    "bcast": ("linear", "binomial"),
    "allgather": ("linear", "bruck", "ring"),
    "alltoall": ("linear", "bruck", "pairwise"),
    "reduce": ("linear", "binomial"),
    "gather": ("linear", "binomial"),
    "scatter": ("linear", "binomial"),
}
algs = sorted({a for v in SCHED.values() for a in v})
for alg in ["auto"] + algs:
    mca_var.set_value("hier_inter_algorithm", alg)
    try:
        xi = rows(lambda r: (np.arange(300, dtype=np.int32) * 7 + r) % 97)
        xf = rows(lambda r: np.sin(np.arange(3000, dtype=np.float32)
                                   + r).astype(np.float32))
        OUT[f"sched_{alg}_allreduce_i32"] = got = npy(world.allreduce(xi))
        np.testing.assert_array_equal(got[0], sum(
            (np.arange(300, dtype=np.int32) * 7 + r) % 97 for r in range(n)))
        OUT[f"sched_{alg}_allreduce_f32"] = npy(world.allreduce(xf))
        OUT[f"sched_{alg}_allreduce_max"] = npy(world.allreduce(xf, ops.MAX))
        OUT[f"sched_{alg}_bcast"] = got = npy(world.bcast(xf, root=5))
        np.testing.assert_array_equal(got[0], np.sin(
            np.arange(3000, dtype=np.float32) + 5).astype(np.float32))
        OUT[f"sched_{alg}_allgather"] = npy(world.allgather(xi))
        xb = rows(lambda r: (np.arange(64, dtype=np.float32) * 0.5 + r)
                  .astype(ml_dtypes.bfloat16))
        OUT[f"sched_{alg}_allgather_bf16"] = npy(world.allgather(xb))
        OUT[f"sched_{alg}_alltoall"] = npy(world.alltoall(
            rows(lambda r: np.arange(16, dtype=np.int32) + 100 * r)))
        OUT[f"sched_{alg}_rsb"] = npy(world.reduce_scatter_block(
            rows(lambda r: np.arange(16, dtype=np.float32) * (r - 3))))
        OUT[f"sched_{alg}_reduce"] = npy(world.reduce(xf, root=6))
        OUT[f"sched_{alg}_gather"] = npy(world.gather(xi, root=2))
        OUT[f"sched_{alg}_scatter"] = npy(world.scatter(
            rows(lambda r: np.arange(8 * 3, dtype=np.int32) * (r + 1)),
            root=6))
        OUT[f"sched_{alg}_scan"] = npy(world.scan(xf))
        OUT[f"sched_{alg}_exscan"] = npy(world.exscan(xi))
        world.barrier()
    finally:
        mca_var.VARS.unset("hier_inter_algorithm")

# v-collectives (ragged, one buffer per LOCAL member)
counts = np.array([[(i + j) % 3 + 1 for j in range(n)] for i in range(n)])
sendbufs = [np.arange(int(counts[r].sum()), dtype=np.float32) + 100 * r
            for r in range(off, off + 4)]
OUT["v_alltoallv"] = np.concatenate([npy(a) for a in
                                     world.alltoallv(sendbufs, counts)])
ragged = [np.arange(r + 1, dtype=np.int32) * (r + 2)
          for r in range(off, off + 4)]
OUT["v_allgatherv"] = got = npy(world.allgatherv(ragged))
np.testing.assert_array_equal(got, np.concatenate(
    [np.arange(r + 1, dtype=np.int32) * (r + 2) for r in range(n)]))
gv = world.gatherv(ragged, root=1)
OUT["v_gatherv"] = npy(gv) if gv is not None else np.zeros(0, np.int32)
sv = world.scatterv(np.arange(36, dtype=np.float32),
                    list(range(1, 9)), root=6)
OUT["v_scatterv"] = np.concatenate([npy(a) for a in sv])
rs = world.reduce_scatter(rows(lambda r: np.arange(36, dtype=np.float32)
                               * (r + 1)), list(range(1, 9)))
OUT["v_reduce_scatter"] = np.concatenate([npy(a) for a in rs])

# the inter bytes of one allreduce: one partial per peer at P = 2
b0 = pvar.PVARS.read_all().get("hier_inter_bytes", 0)
world.allreduce(np.ones((4, 1024), np.float32))
sent = pvar.PVARS.read_all()["hier_inter_bytes"] - b0
assert sent == 4096, sent
OUT["inter_bytes"] = np.int64([sent])
world.barrier()
"""


@pytest.fixture(scope="module")
def coll_dumps(tmp_path_factory):
    return _parity(tmp_path_factory, COLL_BODY + "mpi.finalize()\n", "coll")


GROUPS = ["allreduce_f32", "sched_auto", "sched_linear",
          "sched_recursive_doubling", "sched_ring", "sched_rabenseifner",
          "sched_binomial", "sched_bruck", "sched_pairwise", "v_",
          "inter_bytes"]


class TestUnifiedWorld:
    @pytest.mark.parametrize("prefix", GROUPS)
    def test_hier_collectives_bitwise_the_jax_package(self, coll_dumps,
                                                      prefix):
        """Every hier collective and v-collective, under every forced
        inter schedule: the port's workers dump the JAX package's
        bits."""
        _assert_bitwise(coll_dumps, prefix)

    def test_schedules_agree_on_exact_inputs(self, coll_dumps):
        """Integer inputs are exact under any fold order: every forced
        schedule gives the auto pick's bits."""
        for d in coll_dumps["torch"]:
            for alg in ("linear", "recursive_doubling", "ring",
                        "rabenseifner"):
                assert d[f"sched_{alg}_allreduce_i32"].tobytes() == \
                    d["sched_auto_allreduce_i32"].tobytes()


P2P_BODY = """
OUT = {}
world = init()
rt = Runtime.current()
off = rt.local_rank_offset
log = []
# send/recv across the boundary, both directions, several tags
if off == 0:
    world.send(np.arange(5, dtype=np.int32), 5, tag=3, rank=1)
    world.send(np.float32([1.5, 2.5]), 6, tag=4, rank=2)
    v, st = world.recv(source=-1, tag=9, rank=0)
    log.append(np.concatenate([npy(v).astype(np.float64).ravel(),
                               [st.source, st.tag]]))
    v, st = world.recv(source=7, tag=-1, rank=3)
    log.append(np.concatenate([npy(v).astype(np.float64).ravel(),
                               [st.source, st.tag]]))
else:
    v, st = world.recv(source=1, tag=3, rank=5)
    log.append(np.concatenate([npy(v).astype(np.float64).ravel(),
                               [st.source, st.tag]]))
    world.send(npy(v) * 2, 0, tag=9, rank=4)
    v, st = world.recv(source=-1, tag=-1, rank=6)
    log.append(np.concatenate([npy(v).astype(np.float64).ravel(),
                               [st.source, st.tag]]))
    world.send(np.int64([7, 7, 7]), 3, tag=11, rank=7)
world.barrier()
# non-overtaking across the wire: many messages one (src, tag), then
# probes and wildcard receives in order
if off == 0:
    for k in range(6):
        world.send(np.int32([k, 10 * k]), 4, tag=21 + (k % 2), rank=0)
else:
    import time
    st = None
    deadline = time.time() + 30
    while st is None and time.time() < deadline:
        st = world.iprobe(source=-1, tag=22, rank=4)
    log.append(np.float64([st.source, st.tag]))
    for k in range(6):
        v, st = world.recv(source=-1, tag=-1, rank=4)
        log.append(np.concatenate([npy(v).astype(np.float64),
                                   [st.source, st.tag]]))
world.barrier()
# ssend completes on the remote match
if off == 0:
    world.send(np.float32([3.0]), 5, tag=31, rank=2, sync=True)
    log.append(np.float64([1.0]))
else:
    v, st = world.recv(source=2, tag=31, rank=5)
    log.append(np.concatenate([npy(v).astype(np.float64), [st.source]]))
world.barrier()
# acting as a foreign rank is refused
try:
    world.send(np.int32([1]), 0, tag=1, rank=(off + 4) % 8)
    raise SystemExit("FAIL: a foreign acting rank was accepted")
except MPIError:
    pass
for i, a in enumerate(log):
    OUT[f"p2p_{i:02d}"] = np.asarray(a, np.float64)
world.barrier()
"""


class TestCrossProcessP2P:
    def test_send_recv_wildcards_probe_ssend_same_sequence(
            self, tmp_path_factory):
        """The same send/recv/probe/ssend sequences deliver the same
        messages in the same order through both packages."""
        dumps = _parity(tmp_path_factory, P2P_BODY + "mpi.finalize()\n",
                        "p2p")
        _assert_bitwise(dumps, "p2p_")
        t1 = dumps["torch"][1]
        # closed forms: the doubled echo, the 6 messages in send order
        np.testing.assert_array_equal(t1["p2p_00"], [0, 1, 2, 3, 4, 1, 3])
        order = [tuple(t1[f"p2p_{i:02d}"][:2]) for i in range(3, 9)]
        assert order == [(k, 10 * k) for k in range(6)]


def _port_job(tmp_path, capfd, body, n=2, nvirt=4, env=None, timeout=180):
    rc, job = _run_job(PortJob, PORT_PRELUDE, body, tmp_path, "app", n,
                       nvirt, (), env, timeout)
    out = capfd.readouterr()
    assert rc == 0, out.out + out.err
    assert job.job_state.visited(JobState.TERMINATED)
    return out.out


class TestPortOnlyJobs:
    def test_split_type_shared_gives_local_comm(self, tmp_path, capfd):
        out = _port_job(tmp_path, capfd, """
            world = init()
            rt = Runtime.current()
            assert world._coll_providers["allreduce"] == ["hier"]
            subs = world.split_type_shared()
            off = rt.local_rank_offset
            sub = subs[off]
            assert sub is not None and sub.size == 4
            assert not sub.spans_processes
            assert "hier" not in sub._coll_providers["allreduce"]
            got = npy(sub.allreduce(np.stack([np.int32([r])
                                              for r in range(4)])))
            assert (got == 6).all()
            print(f"SPLIT-OK {off}")
            mpi.finalize()
        """)
        assert "SPLIT-OK 0" in out and "SPLIT-OK 4" in out

    def test_three_process_cid_sync_after_partial_split(self, tmp_path,
                                                        capfd):
        out = _port_job(tmp_path, capfd, """
            world = init()          # 3 procs x 2 ranks = 6 ranks
            rt = Runtime.current()
            off = rt.local_rank_offset
            assert world.size == 6, world.size
            subs = world.split([0, 0, 0, 0, 1, 1])
            sub = subs[off]
            if off in (0, 2):
                assert sub.spans_processes
                got = npy(sub.allreduce(
                    np.stack([np.int32([off + i]) for i in range(2)])))
                assert (got == 0 + 1 + 2 + 3).all(), got
            else:
                assert not sub.spans_processes and sub.size == 2
                other = subs[0]
                try:
                    other.recv(rank=0)
                    raise SystemExit("FAIL: foreign comm recv worked")
                except MPIError:
                    pass
            later = world.dup(name="later")
            assert later.cid >= 0 and sub.cid >= 0
            if off == 0:
                later.send(np.int32([99]), 5, tag=1, rank=0)
            elif off == 4:
                val, st = later.recv(source=0, tag=1, rank=5)
                assert int(npy(val)[0]) == 99 and st.source == 0
                print("CID-SYNC-OK")
            world.barrier()
            mpi.finalize()
        """, n=3, nvirt=2)
        assert "CID-SYNC-OK" in out

    def test_cross_process_surface_over_dcn_staging(self, tmp_path, capfd):
        """Distinct host identities force the DCN staging path: the
        collectives and a large send stay bitwise and the staged
        fragment path carries bytes."""
        out = _port_job(tmp_path, capfd, """
            os.environ["OMPITPU_HOST_ID"] = (
                "fakehost-" + os.environ["OMPITPU_NODE_ID"])
            world = init()
            rt = Runtime.current()
            off = rt.local_rank_offset
            x = np.stack([np.arange(65536, dtype=np.int32) * (off + i + 1)
                          for i in range(4)])
            got = npy(world.allreduce(x))
            want = sum(np.arange(65536, dtype=np.int32) * (r + 1)
                       for r in range(8))
            np.testing.assert_array_equal(got[0], want)
            big = torch.arange(1 << 19, dtype=torch.float32) * -2.0
            if off == 0:
                world.send(big, 6, tag=2, rank=2)
            else:
                v, st = world.recv(source=2, tag=2, rank=6)
                assert torch.equal(v, big)
            world.barrier()
            assert pvar.PVARS.read_all()["wire_bytes_zero_copy"] > 0
            print(f"DCN-OK {off}")
            mpi.finalize()
        """)
        assert "DCN-OK 0" in out and "DCN-OK 4" in out

    def test_pair_op_allreduce_and_reduce(self, tmp_path, capfd):
        """MAXLOC/MINLOC over the spanning world (the pair payload packed
        into one wire message per peer), under the default in-process
        component: the closed form, ties to the lower index."""
        out = _port_job(tmp_path, capfd, """
            world = init()
            off = Runtime.current().local_rank_offset
            vals = np.stack([np.float32([r % 3, -r, 2.0, 7 - r])
                             for r in range(off, off + 4)])
            idxs = np.stack([np.int32([r, r, r, r])
                             for r in range(off, off + 4)])
            for alg in ("auto", "linear", "ring"):
                mca_var.set_value("hier_inter_algorithm", alg)
                v, i = world.allreduce((vals, idxs), ops.MAXLOC)
                np.testing.assert_array_equal(npy(v)[0], [2, 0, 2, 7])
                np.testing.assert_array_equal(npy(i)[0], [2, 0, 0, 0])
                v, i = world.allreduce((vals, idxs), ops.MINLOC)
                np.testing.assert_array_equal(npy(v)[0], [0, -7, 2, 0])
                np.testing.assert_array_equal(npy(i)[0], [0, 7, 0, 7])
                mca_var.VARS.unset("hier_inter_algorithm")
            print(f"PAIR-OK {off}")
            mpi.finalize()
        """)
        assert "PAIR-OK 0" in out and "PAIR-OK 4" in out

    def test_unified_world_opt_out(self, tmp_path, capfd):
        out = _port_job(tmp_path, capfd, """
            mca_var.set_value("runtime_unified_world", False)
            world = init()
            rt = Runtime.current()
            assert world.size == 4 and not world.spans_processes
            assert rt.wire is None and not rt.unified
            got = npy(world.allreduce(np.ones((4, 3), np.float32)))
            assert (got == 4).all()
            print(f"OPTOUT-OK {rt.bootstrap['process_index']}")
            mpi.finalize()
        """)
        assert "OPTOUT-OK 0" in out and "OPTOUT-OK 1" in out

    def test_failed_worker_fails_the_job(self, tmp_path, capfd):
        """A worker that raises after wire-up makes the job exit
        non-zero; the launcher reaps every worker."""
        rc, job = _run_job(PortJob, PORT_PRELUDE, """
            world = init()
            if Runtime.current().bootstrap["process_index"] == 1:
                raise SystemExit(3)
            world.barrier()
        """, tmp_path, "app", 2, 4, timeout=60)
        capfd.readouterr()
        assert rc != 0
        assert job.job_state.visited(JobState.ABORTED)
        assert all(p.poll() is not None for p in job.procs.values())
