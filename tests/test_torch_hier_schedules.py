"""The port's inter-process schedules (``coll/hier_schedules.py``,
``coll/topo_schedules.py``) and their use in ``coll/hier.py``, held
against ``tests/test_hier_schedules.py``.

1. The JAX package's lockstep simulator (``testing.lockstep.simulate``:
   one thread per process, per-(src, dst) FIFO queues — the transport
   contract the wire gives) drives the port's schedules and the JAX
   package's on the same inputs; every result is compared BITWISE, and
   against the reference test's closed forms. The port's combiner is
   its own op on torch tensors.
2. Selection (``pick``: forcing > rules > fixed constants, the
   non-commutative downgrades) agrees with the JAX package's over a
   grid; the shipped rules file parses with its ``hier_*`` lines; the
   pair-op payload packing round-trips.
3. ``tpurun`` jobs of the port: the allreduce family forced in turn on
   3 processes, and the leader tier over a faked two-host layout.
"""

import os
import sys
import textwrap

import numpy as np
import pytest
import torch

from ompi_release_tpu import ops as jops
from ompi_release_tpu.coll import hier_schedules as jhs
from ompi_release_tpu.coll import topo_schedules as jtopo
from ompi_release_tpu.testing.lockstep import simulate
from ompi_release_tpu_torch import ops as tops
from ompi_release_tpu_torch.coll import hier_schedules as hs
from ompi_release_tpu_torch.coll import topo_schedules as topo
from ompi_release_tpu_torch.coll.hier import _HierModule
from ompi_release_tpu_torch.mca import var as mca_var
from ompi_release_tpu_torch.runtime.state import JobState
from ompi_release_tpu_torch.tools.tpurun import Job
from ompi_release_tpu_torch.utils.errors import MPIError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROC_SETS = ([3, 9], [0, 1, 5], [2, 4, 6, 8], [1, 2, 3, 5, 7],
             list(range(8)))
OPS = ["sum", "prod", "max", "min", "band"]


def _tnp(op):
    """The port's op as a combiner on host chunks (torch on the CPU)."""
    return lambda a, b: op(torch.from_numpy(np.ascontiguousarray(a)),
                           torch.from_numpy(np.ascontiguousarray(b))).numpy()


def _jnp(op):
    return lambda a, b: np.asarray(op(a, b))


def _linear_fold(parts, npop):
    acc = parts[0]
    for nxt in parts[1:]:
        acc = npop(acc, nxt)
    return acc


def _both(procs, port_fn, jax_fn):
    """Run one schedule through both packages' modules."""
    return (simulate(procs, port_fn), simulate(procs, jax_fn))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


class TestAllreduceParityMatrix:
    @pytest.mark.parametrize("procs", PROC_SETS,
                             ids=lambda p: f"P{len(p)}")
    @pytest.mark.parametrize("dtype", [np.int32, np.float32])
    def test_matrix(self, procs, dtype):
        """ring, rabenseifner, multiring and recursive doubling over
        the port's schedules and combiner give the JAX package's bits;
        order-invariant cases are bitwise the linear fold."""
        rng = np.random.RandomState(len(procs))
        P = len(procs)
        for name in OPS:
            if name == "band" and dtype is np.float32:
                continue
            top, jop = tops.PREDEFINED_OPS[name], jops.PREDEFINED_OPS[name]
            hi = 4 if name == "prod" else 100
            data = {p: rng.randint(1, hi, 13).astype(dtype) for p in procs}
            ident = np.asarray(jop.identity_for(dtype), dtype)
            want = _linear_fold([data[p] for p in procs], _jnp(jop))
            for alg in ("ring", "rabenseifner", "multiring"):
                if alg == "multiring":
                    tf = lambda x, p: topo.allreduce_multiring(  # noqa
                        x, procs, p, data[p], _tnp(top), ident, 3)
                    jf = lambda x, p: jtopo.allreduce_multiring(  # noqa
                        x, procs, p, data[p], _jnp(jop), ident, 3)
                else:
                    fn, jfn = ((hs.allreduce_ring, jhs.allreduce_ring)
                               if alg == "ring" else
                               (hs.allreduce_rabenseifner,
                                jhs.allreduce_rabenseifner))
                    tf = lambda x, p, fn=fn: fn(  # noqa
                        x, procs, p, data[p], _tnp(top), ident)
                    jf = lambda x, p, fn=jfn: fn(  # noqa
                        x, procs, p, data[p], _jnp(jop), ident)
                tout, jout = _both(procs, tf, jf)
                for p in procs:
                    got = np.asarray(tout[p]).astype(dtype)
                    assert _same(got, np.asarray(jout[p]).astype(dtype)), (
                        alg, name, P)
                    if dtype is np.int32 or name not in ("sum", "prod"):
                        np.testing.assert_array_equal(got, want)
                    else:
                        np.testing.assert_allclose(got, want, rtol=1e-6)
            tout, jout = _both(
                procs,
                lambda x, p: _linear_fold(hs.allgather_bruck(
                    x, procs, p, data[p], [13] * P), _tnp(top)),
                lambda x, p: _linear_fold(jhs.allgather_bruck(
                    x, procs, p, data[p], [13] * P), _jnp(jop)))
            for p in procs:
                assert _same(tout[p], jout[p])
                np.testing.assert_array_equal(tout[p], want)

    @pytest.mark.parametrize("procs", PROC_SETS,
                             ids=lambda p: f"P{len(p)}")
    def test_noncommutative_exact_via_recursive_doubling(self, procs):
        sub = tops.user_op("sub_t", lambda a, b: a - b, commute=False)
        rng = np.random.RandomState(7)
        data = {p: rng.randint(0, 50, 9).astype(np.int64) for p in procs}
        want = _linear_fold([data[p] for p in procs], lambda a, b: a - b)
        P = len(procs)
        out = simulate(procs, lambda x, p: _linear_fold(
            hs.allgather_bruck(x, procs, p, data[p], [9] * P), _tnp(sub)))
        for p in procs:
            np.testing.assert_array_equal(np.asarray(out[p]), want)

    def test_torus2d_allreduce_matches(self):
        procs = [0, 1, 2, 3, 4, 5]
        host_of = {p: f"h{p // 3}" for p in procs}
        data = {p: (np.arange(20, dtype=np.int32) * (p + 1)) for p in procs}
        ident = np.int32(0)
        tout, jout = _both(
            procs,
            lambda x, p: topo.allreduce_torus2d(
                x, procs, p, data[p], _tnp(tops.SUM), ident, host_of),
            lambda x, p: jtopo.allreduce_torus2d(
                x, procs, p, data[p], _jnp(jops.SUM), ident, host_of))
        want = sum(data.values())
        for p in procs:
            assert _same(tout[p], jout[p])
            np.testing.assert_array_equal(tout[p], want)


class TestMovementSchedules:
    @pytest.mark.parametrize("procs", PROC_SETS,
                             ids=lambda p: f"P{len(p)}")
    def test_bcast_binomial_every_root(self, procs):
        val = np.random.RandomState(1).randint(0, 99, (4, 3)).astype(
            np.int32)
        for root in procs:
            out = simulate(procs, lambda x, p: hs.bcast_binomial(
                x, procs, p, root, val if p == root else None))
            for p in procs:
                np.testing.assert_array_equal(np.asarray(out[p]), val)

    @pytest.mark.parametrize("procs", PROC_SETS,
                             ids=lambda p: f"P{len(p)}")
    def test_gather_scatter_binomial(self, procs):
        P = len(procs)
        rng = np.random.RandomState(2)
        counts = [(i % 3) + 1 for i in range(P)]
        data = {p: rng.randint(0, 99, counts[i] * 4).astype(np.int32)
                for i, p in enumerate(procs)}
        for root in (procs[0], procs[-1], procs[P // 2]):
            out = simulate(procs, lambda x, p: hs.gather_binomial(
                x, procs, p, root, data[p], [c * 4 for c in counts]))
            for p in procs:
                if p == root:
                    for j, q in enumerate(procs):
                        np.testing.assert_array_equal(out[p][j], data[q])
                else:
                    assert out[p] is None
            sc = simulate(procs, lambda x, p: hs.scatter_binomial(
                x, procs, p, root,
                [data[q] for q in procs] if p == root else None,
                counts, np.asarray([4], np.int64) if p == root else None))
            for p in procs:
                flat, meta = sc[p]
                np.testing.assert_array_equal(flat, data[p])
                assert list(meta) == [4]

    @pytest.mark.parametrize("procs", PROC_SETS,
                             ids=lambda p: f"P{len(p)}")
    def test_allgather_bruck_and_ring_heterogeneous(self, procs):
        rng = np.random.RandomState(3)
        blocks = {p: rng.randint(0, 99, ((i % 2) + 1, 5)).astype(np.int32)
                  for i, p in enumerate(procs)}
        counts = [blocks[p].size for p in procs]
        out = simulate(procs, lambda x, p: hs.allgather_bruck(
            x, procs, p, blocks[p].ravel(), counts))
        for p in procs:
            for i, q in enumerate(procs):
                np.testing.assert_array_equal(out[p][i], blocks[q].ravel())
        out = simulate(procs, lambda x, p: hs.allgather_ring(
            x, procs, p, blocks[p]))
        for p in procs:
            for i, q in enumerate(procs):
                np.testing.assert_array_equal(out[p][i], blocks[q])

    @pytest.mark.parametrize("procs", PROC_SETS,
                             ids=lambda p: f"P{len(p)}")
    def test_alltoall_bruck_and_pairwise(self, procs):
        P = len(procs)
        rng = np.random.RandomState(4)
        mlen = [(i % 2) + 1 for i in range(P)]
        pc = [[mlen[o] * mlen[j] * 3 for j in range(P)] for o in range(P)]
        send = {p: [rng.randint(0, 99, pc[i][j]).astype(np.int32)
                    for j in range(P)] for i, p in enumerate(procs)}
        out = simulate(procs, lambda x, p: hs.alltoall_bruck(
            x, procs, p, send[p], pc))
        for i, p in enumerate(procs):
            for j, q in enumerate(procs):
                if q == p:
                    assert out[p][j] is None
                else:
                    np.testing.assert_array_equal(out[p][j], send[q][i])
        payloads = {p: {q: send[p][j] for j, q in enumerate(procs)
                        if q != p} for p in procs}
        out = simulate(procs, lambda x, p: hs.alltoall_pairwise(
            x, procs, p, payloads[p]))
        for i, p in enumerate(procs):
            for j, q in enumerate(procs):
                if q != p:
                    np.testing.assert_array_equal(out[p][q], send[q][i])


class TestSelection:
    def test_fixed_constants(self):
        assert hs.pick("allreduce", 4, 1024) == "recursive_doubling"
        assert hs.pick("allreduce", 4, 1 << 20) == "rabenseifner"
        assert hs.pick("allreduce", 3, 1 << 20) == "ring"
        assert hs.pick("allreduce", 4, 1 << 20,
                       commutative=False) == "recursive_doubling"
        assert hs.pick("allreduce", 4, 1 << 20,
                       has_identity=False) == "recursive_doubling"
        assert hs.pick("bcast", 8, 1 << 20) == "binomial"
        assert hs.pick("reduce", 8, 1024) == "binomial"
        assert hs.pick("reduce", 8, 1 << 20) == "linear"
        assert hs.pick("allgather", 8, 1024) == "bruck"
        assert hs.pick("allgather", 8, 1 << 20) == "linear"
        assert hs.pick("alltoall", 8, 1024) == "bruck"
        assert hs.pick("alltoall", 8, 1 << 20) == "pairwise"
        assert hs.pick("allreduce", 6, 1 << 20, topo=(3, 2)) == "torus2d"

    def test_pick_agrees_with_the_jax_package(self):
        for coll in hs.ALGORITHMS:
            for P in (2, 3, 4, 8):
                for nbytes in (0, 64, 65536, 1 << 20, 1 << 28):
                    for kw in ({}, {"commutative": False},
                               {"pair_op": True}, {"topo": (2, 2)}):
                        assert hs.pick(coll, P, nbytes, **kw) == \
                            jhs.pick(coll, P, nbytes, **kw), (
                                coll, P, nbytes, kw)

    def test_forcing(self):
        mca_var.set_value("hier_inter_algorithm", "ring")
        try:
            assert hs.pick("allreduce", 4, 64) == "ring"
            with pytest.raises(MPIError):
                hs.pick("allreduce", 4, 64, commutative=False)
            assert hs.pick("allreduce", 4, 64,
                           pair_op=True) == "recursive_doubling"
            assert hs.pick("bcast", 4, 64) == "binomial"
        finally:
            mca_var.VARS.unset("hier_inter_algorithm")

    def test_dynamic_rules_and_noncommutative_downgrade(self, tmp_path):
        from ompi_release_tpu_torch.coll.base import COLL_FRAMEWORK

        import ompi_release_tpu_torch.coll.components  # noqa: F401

        COLL_FRAMEWORK.lookup("tuned").register_vars()
        rules = tmp_path / "hier.conf"
        rules.write_text(textwrap.dedent("""
            hier_allreduce  0  0       linear
            hier_allreduce  0  4096    ring
            hier_bcast      0  0       linear
        """))
        mca_var.set_value("coll_tuned_use_dynamic_rules", True)
        mca_var.set_value("coll_tuned_dynamic_rules_filename", str(rules))
        try:
            assert hs.pick("allreduce", 4, 100) == "linear"
            assert hs.pick("allreduce", 4, 8192) == "ring"
            assert hs.pick("allreduce", 4, 8192,
                           commutative=False) == "recursive_doubling"
            assert hs.pick("bcast", 4, 8192) == "linear"
            assert hs.pick("alltoall", 4, 100) == "bruck"
        finally:
            mca_var.VARS.unset("coll_tuned_use_dynamic_rules")
            mca_var.VARS.unset("coll_tuned_dynamic_rules_filename")

    def test_shipped_rules_file_parses_with_hier_lines(self):
        from ompi_release_tpu_torch.coll import dynamic_rules

        rules = dynamic_rules.load_rules(
            os.path.join(REPO, "tuning", "cpu8_rules.conf"))
        assert any(k.startswith("hier_") for k in rules), list(rules)


class TestPairPacking:
    @pytest.mark.parametrize("vdt,idt", [(np.float32, np.int32),
                                         (np.float32, np.int64),
                                         (np.float64, np.int32)])
    def test_roundtrip(self, vdt, idt):
        from ompi_release_tpu.coll.hier import _HierModule as _J

        rng = np.random.RandomState(0)
        pv = rng.randn(3, 5).astype(vdt)
        pi = rng.randint(0, 99, (3, 5)).astype(idt)
        buf = _HierModule._pack_pair(pv, pi)
        assert buf.dtype == np.uint8 and buf.nbytes == pv.nbytes + pi.nbytes
        assert buf.tobytes() == _J._pack_pair(pv, pi).tobytes()
        v, i = _HierModule._unpack_pair(buf, pv, pi)
        np.testing.assert_array_equal(v, pv)
        np.testing.assert_array_equal(i, pi)

    def test_roundtrip_odd_offset(self):
        pv = np.arange(3, dtype=np.float32)
        pi = np.arange(3, dtype=np.int64)
        v, i = _HierModule._unpack_pair(_HierModule._pack_pair(pv, pi),
                                        pv, pi)
        np.testing.assert_array_equal(v, pv)
        np.testing.assert_array_equal(i, pi)


APP_PRELUDE = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, %r)
    import numpy as np
    import torch
    import ompi_release_tpu_torch as mpi
    from ompi_release_tpu_torch import ops as _ops
    from ompi_release_tpu_torch.mca import pvar, var as mca_var
    from ompi_release_tpu_torch.runtime.runtime import Runtime

    def _pv(name):
        p = pvar.PVARS.lookup(name)
        return float(p.read()) if p is not None else 0.0

    def force(alg):
        mca_var.set_value("hier_inter_algorithm", alg)

    def init():
        return mpi.init(cli_args=["--mca", "runtime_virtual_ranks", "2"],
                        device="cpu")
""" % REPO)


def _run(tmp_path, capfd, body, n=3, timeout=240):
    app = tmp_path / "app.py"
    app.write_text(APP_PRELUDE + textwrap.dedent(body))
    job = Job(n, [sys.executable, str(app)], [], heartbeat_s=0.5,
              miss_limit=8)
    rc = job.run(timeout_s=timeout)
    out = capfd.readouterr()
    assert rc == 0, out.out + out.err
    assert job.job_state.visited(JobState.TERMINATED)
    return out.out


class TestScheduleJobs:
    def test_allreduce_family_job(self, tmp_path, capfd):
        out = _run(tmp_path, capfd, """
            world = init()
            off = Runtime.current().local_rank_offset
            n = world.size
            x = np.stack([np.arange(64, dtype=np.int32) * (off + i + 1)
                          for i in range(2)])
            want = sum(np.arange(64, dtype=np.int32) * (r + 1)
                       for r in range(n))
            xf = x.astype(np.float32) * 0.125
            wantf = want.astype(np.float32) * 0.125
            bytes_by_alg = {}
            for alg in ("linear", "recursive_doubling", "ring",
                        "rabenseifner"):
                force(alg)
                b0 = _pv("hier_inter_bytes")
                got = world.allreduce(x).numpy()
                bytes_by_alg[alg] = _pv("hier_inter_bytes") - b0
                for i in range(2):
                    np.testing.assert_array_equal(got[i], want)
                gf = world.allreduce(xf).numpy()
                np.testing.assert_allclose(gf[0], wantf, rtol=1e-6)
                pv_ = np.asarray([3., 1., 7., 2., 9., 0.],
                                 np.float32).reshape(n, 1)
                pi_ = np.arange(n, dtype=np.int32).reshape(n, 1)
                rv, ri = world.allreduce(
                    (pv_[off:off+2], pi_[off:off+2]), _ops.MAXLOC)
                assert float(rv[0, 0]) == 9.0 and int(ri[0, 0]) == 4
            assert bytes_by_alg["ring"] < bytes_by_alg["linear"], \\
                bytes_by_alg
            assert _pv("hier_inter_msgs") == \\
                _pv("hier_inter_msgs_sent") + _pv("hier_inter_msgs_recvd")
            world.barrier()
            print(f"ALLREDUCE-FAM-OK {off}")
            mpi.finalize()
        """)
        for off in (0, 2, 4):
            assert f"ALLREDUCE-FAM-OK {off}" in out

    def test_leader_tier_job(self, tmp_path, capfd):
        out = _run(tmp_path, capfd, """
            nid = int(os.environ["OMPITPU_NODE_ID"])
            os.environ["OMPITPU_HOST_ID"] = "hostA" if nid <= 2 else "hostB"
            world = init()
            rt = Runtime.current()
            off = rt.local_rank_offset
            me = rt.bootstrap["process_index"]
            n = world.size
            x = np.stack([np.arange(32, dtype=np.int32) * (off + i + 1)
                          for i in range(2)])
            want = sum(np.arange(32, dtype=np.int32) * (r + 1)
                       for r in range(n))
            s0 = _pv("hier_inter_msgs_sent")
            got = world.allreduce(x).numpy()
            d_sent = _pv("hier_inter_msgs_sent") - s0
            np.testing.assert_array_equal(got[0], want)
            lc = _pv("hier_leader_combines")
            if me == 0:
                assert lc >= 1, lc
            if me == 1:
                assert lc == 0 and d_sent == 1, (lc, d_sent)
            full = np.stack([np.arange(8, dtype=np.int32) + 10 * r
                             for r in range(n)])
            got = world.bcast(full[off:off+2], root=5).numpy()
            np.testing.assert_array_equal(got[0], full[5])
            mca_var.set_value("hier_leader_tier", False)
            l0 = _pv("hier_leader_combines")
            got = world.allreduce(x).numpy()
            np.testing.assert_array_equal(got[0], want)
            assert _pv("hier_leader_combines") == l0
            world.barrier()
            print(f"LEADER-OK {me}")
            mpi.finalize()
        """)
        for me in (0, 1, 2):
            assert f"LEADER-OK {me}" in out
