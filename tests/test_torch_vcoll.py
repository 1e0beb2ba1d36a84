"""v-variant collectives of the PyTorch port held against the JAX
package: alltoallv (with its skew cap), allgatherv, gatherv, scatterv,
general reduce_scatter, the size-1 comm and ``dropless_moe``.

Each case of ``tests/test_vcoll.py`` runs under both providers (the
fused component, the ``xla`` counterpart, and tuned) in both packages
on the same numpy inputs. Moving collectives are BITWISE equal.
reduce_scatter under tuned is the ring (a fixed order: bitwise); under
fused it folds in the port's declared order (:func:`spmd.fold_ranks`),
held within rtol=1e-6 of JAX's ``psum`` on positive inputs and exact on
integer-valued ones.
"""

import contextlib

import numpy as np
import pytest
import torch

import ompi_release_tpu as jmpi
from ompi_release_tpu import ops as jops
from ompi_release_tpu.mca import var as jvar
import ompi_release_tpu_torch as tmpi
from ompi_release_tpu_torch import ops as tops
from ompi_release_tpu_torch.mca import pvar as tpvar
from ompi_release_tpu_torch.mca import var as tvar
from ompi_release_tpu_torch.runtime import runtime as trt
from ompi_release_tpu_torch.utils.errors import ErrorCode, MPIError

N = 8


@contextlib.contextmanager
def both(**kv):
    for k, v in kv.items():
        jvar.set_value(k, v)
        tvar.set_value(k, v)
    try:
        yield
    finally:
        for k in kv:
            jvar.VARS.unset(k)
            tvar.VARS.unset(k)


@pytest.fixture(scope="module")
def worlds():
    jworld = jmpi.init()
    trt._reset_for_tests()
    tworld = tmpi.init(cli_args=["--mca", "runtime_virtual_ranks", str(N)],
                       device="cpu")
    yield jworld, tworld
    trt._reset_for_tests()
    tvar.VARS.unset("runtime_virtual_ranks")


@pytest.fixture(params=["fused", "tuned"])
def comms(worlds, request):
    """Each v-collective under both providers: fused (JAX: xla) and
    tuned."""
    jworld, tworld = worlds
    jname = "xla" if request.param == "fused" else "tuned"
    jvar.set_value("coll", jname)
    tvar.set_value("coll", request.param)
    try:
        jc = jworld.dup(name=f"vcoll_{request.param}")
        tc = tworld.dup(name=f"vcoll_{request.param}")
    finally:
        jvar.VARS.unset("coll")
        tvar.VARS.unset("coll")
    assert tc._coll_providers["alltoallv"][0] == request.param
    yield jc, tc
    jc.free()
    tc.free()


def _ragged_counts(n, seed=0, lo=0, hi=7):
    return np.random.RandomState(seed).randint(lo, hi, size=(n, n)).astype(
        np.int64)


def _same(jout, tout):
    j = np.asarray(jout)
    t = tout.detach().cpu().numpy()
    assert j.shape == t.shape and j.dtype.itemsize == t.dtype.itemsize
    uint = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[
        j.dtype.itemsize]
    np.testing.assert_array_equal(j.view(uint), t.view(uint))


def _same_lists(jl, tl):
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        _same(j, t)


def _mpi_alltoallv(bufs, c):
    """MPI_Alltoallv's receive buffers, on the host."""
    n = len(bufs)
    offs = np.concatenate([np.zeros((n, 1), np.int64), np.cumsum(c, 1)], 1)
    return [np.concatenate([bufs[j][offs[j, i]:offs[j, i] + c[j, i]]
                            for j in range(n)]) for i in range(n)]


class TestAlltoallv:
    def test_parity_ragged(self, comms):
        jc, tc = comms
        c = _ragged_counts(N, seed=1)
        rng = np.random.RandomState(2)
        bufs = [rng.randn(int(c[i].sum())).astype(np.float32)
                for i in range(N)]
        trecv = tc.alltoallv(bufs, c)
        _same_lists(jc.alltoallv(bufs, c), trecv)
        for t, want in zip(trecv, _mpi_alltoallv(bufs, c)):
            np.testing.assert_array_equal(t.numpy(), want)

    def test_zero_counts_rank(self, comms):
        """A rank sending nothing at all still participates."""
        jc, tc = comms
        c = _ragged_counts(N, seed=3)
        c[0, :] = 0
        bufs = [np.arange(int(c[i].sum()), dtype=np.int32) * (i + 1)
                for i in range(N)]
        trecv = tc.alltoallv(bufs, c)
        assert trecv[1].dtype == torch.int32
        assert tuple(trecv[1].shape) == (int(c[:, 1].sum()),)
        _same_lists(jc.alltoallv(bufs, c), trecv)

    def test_count_mismatch_raises(self, comms):
        _, tc = comms
        c = np.ones((N, N), np.int64)
        with pytest.raises(MPIError) as e:
            tc.alltoallv([np.zeros(5, np.float32)] * N, c)
        assert e.value.code == ErrorCode.ERR_COUNT

    def test_one_program_across_count_matrices(self, comms):
        """Count matrices of one padded width reuse one cached program
        (counts live at the edge, not in the key)."""
        _, tc = comms
        compiled = tpvar.PVARS.lookup("coll_programs_compiled")
        c1 = _ragged_counts(N, seed=5, lo=1, hi=5)
        c2 = _ragged_counts(N, seed=6, lo=1, hi=5)
        c1.flat[0] = 4
        c2.flat[0] = 4
        tc.alltoallv([np.ones(int(c1[i].sum()), np.float32)
                      for i in range(N)], c1)
        before = compiled.read()
        tc.alltoallv([np.ones(int(c2[i].sum()), np.float32)
                      for i in range(N)], c2)
        assert compiled.read() == before


class TestAllgatherv:
    def test_parity_ragged(self, comms):
        jc, tc = comms
        rng = np.random.RandomState(7)
        lens = rng.randint(0, 9, size=N)
        bufs = [rng.randn(int(k)).astype(np.float32) for k in lens]
        out = tc.allgatherv(bufs)
        _same(jc.allgatherv(bufs), out)
        np.testing.assert_array_equal(out.numpy(), np.concatenate(bufs))

    def test_gatherv_root_view(self, comms):
        jc, tc = comms
        bufs = [np.full(i + 1, i, np.int32) for i in range(N)]
        out = tc.gatherv(bufs, root=2)
        _same(jc.gatherv(bufs, root=2), out)
        with pytest.raises(MPIError):
            tc.gatherv(bufs, root=N)


class TestScatterv:
    def test_parity_ragged(self, comms):
        jc, tc = comms
        rng = np.random.RandomState(8)
        counts = rng.randint(0, 6, size=N).tolist()
        buf = rng.randn(sum(counts)).astype(np.float32)
        parts = tc.scatterv(buf, counts, root=1)
        _same_lists(jc.scatterv(buf, counts, root=1), parts)
        off = 0
        for i, k in enumerate(counts):
            np.testing.assert_array_equal(parts[i].numpy(), buf[off:off + k])
            off += k

    def test_bad_root_raises(self, comms):
        _, tc = comms
        with pytest.raises(MPIError) as e:
            tc.scatterv(np.zeros(4, np.float32), [1] * N, root=N)
        assert e.value.code == ErrorCode.ERR_ROOT


class TestReduceScatterV:
    def test_sum_parity_ragged(self, comms, request):
        jc, tc = comms
        rng = np.random.RandomState(9)
        recvcounts = rng.randint(1, 6, size=N).tolist()
        total = sum(recvcounts)
        x = rng.randn(N, total).astype(np.float32)
        jparts = jc.reduce_scatter(x, recvcounts)
        tparts = tc.reduce_scatter(x, recvcounts)
        if tc._coll_providers["reduce_scatter"][0] == "tuned":
            _same_lists(jparts, tparts)  # the ring: one fixed order
        pos = np.abs(x) + 0.5
        jp = jc.reduce_scatter(pos, recvcounts)
        tp = tc.reduce_scatter(pos, recvcounts)
        for j, t in zip(jp, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                       atol=0)
        ints = rng.randint(-50, 50, size=(N, total)).astype(np.float32)
        _same_lists(jc.reduce_scatter(ints, recvcounts),
                    tc.reduce_scatter(ints, recvcounts))
        red = x.sum(axis=0)
        offs = np.concatenate([[0], np.cumsum(recvcounts)])
        for i in range(N):
            np.testing.assert_allclose(tparts[i].numpy(),
                                       red[offs[i]:offs[i + 1]],
                                       rtol=2e-5, atol=1e-5)

    def test_max_parity(self, comms):
        jc, tc = comms
        rng = np.random.RandomState(10)
        recvcounts = [2] * (N - 1) + [5]
        x = rng.randn(N, sum(recvcounts)).astype(np.float32)
        _same_lists(jc.reduce_scatter(x, recvcounts, jops.MAX),
                    tc.reduce_scatter(x, recvcounts, tops.MAX))


class TestSelfSize1:
    def test_v_variants_on_self_comm(self, worlds):
        jw, tw = worlds
        jsub = jw.create(jw.group.incl([0]), name="solo")
        tsub = tw.create(tw.group.incl([0]), name="solo")
        try:
            x = np.arange(5, dtype=np.float32)
            _same_lists(jsub.alltoallv([x], np.array([[5]])),
                        tsub.alltoallv([x], np.array([[5]])))
            _same(jsub.allgatherv([x]), tsub.allgatherv([x]))
            _same(jsub.gatherv([x], 0), tsub.gatherv([x], 0))
            _same_lists(jsub.scatterv(x, [5], root=0),
                        tsub.scatterv(x, [5], root=0))
            _same_lists(jsub.reduce_scatter(x[None, :], [5]),
                        tsub.reduce_scatter(x[None, :], [5]))
            with pytest.raises(MPIError):
                tsub.alltoallv([x], np.array([[4]]))
        finally:
            jsub.free()
            tsub.free()


class TestDroplessEp:
    def test_dropless_moe_parity(self, worlds):
        """Uneven expert loads routed exactly (no drops) match JAX's
        dropless_moe and the per-token computation, bitwise."""
        from ompi_release_tpu.parallel.ep import dropless_moe as jdropless
        from ompi_release_tpu_torch.parallel.ep import dropless_moe

        jw, tw = worlds
        n_experts = 2 * N
        rng = np.random.RandomState(11)
        d = 4
        lens = rng.randint(1, 10, size=N)
        tokens = [rng.randn(int(k), d).astype(np.float32) for k in lens]
        assigns = [rng.randint(0, n_experts, size=int(k)) for k in lens]

        def expert_fn(e, x):
            return x * (e + 1) + 0.5

        outs = dropless_moe(tw, tokens, assigns, expert_fn, n_experts)
        _same_lists(jdropless(jw, tokens, assigns, expert_fn, n_experts),
                    outs)
        for i in range(N):
            want = tokens[i] * (assigns[i][:, None] + 1).astype(
                np.float32) + np.float32(0.5)
            np.testing.assert_array_equal(outs[i].numpy(), want)

    def test_dropless_moe_spanning_comm_not_available(self, worlds):
        """On a communicator spanning processes each process acts as its
        local ranks only (the spanning run is held in
        ``tests/test_torch_spanning_jobs.py``): one entry per rank of
        the whole comm is refused."""
        from ompi_release_tpu_torch.parallel.ep import dropless_moe

        _, tw = worlds

        class Spanning:
            spans_processes = True
            size = N
            local_comm_ranks = [0, 1]

        tokens = [np.ones((2, 4), np.float32)] * N
        with pytest.raises(ValueError, match="acting rank \\(2\\)"):
            dropless_moe(Spanning(), tokens, [np.zeros(2)] * N, None, N)


class TestAlltoallvSkew:
    """One hot pair must not make every pair pay its count: the padded
    kernel is capped and the hot tail is delivered at the edge."""

    def test_hot_pair_capped_and_correct(self, worlds):
        jw, tw = worlds
        rng = np.random.RandomState(5)
        counts = np.full((N, N), 4, np.int64)
        counts[0, 1] = 4096
        bufs = [rng.randn(int(counts[i].sum())).astype(np.float32)
                for i in range(N)]
        ov = tpvar.PVARS.lookup("vcoll_alltoallv_overflow_elems")
        before = ov.read()
        trecv = tw.alltoallv(bufs, counts)
        _same_lists(jw.alltoallv(bufs, counts), trecv)
        for t, want in zip(trecv, _mpi_alltoallv(bufs, counts)):
            np.testing.assert_array_equal(t.numpy(), want)
        keys = [k for k in tw._coll_programs if k[:2] == ("lax", "alltoallv")]
        assert keys and any(k[3] <= 8 for k in keys), keys
        assert ov.read() - before == 4096 - 4

    def test_uniform_counts_unaffected(self, worlds):
        jw, tw = worlds
        counts = np.full((N, N), 3, np.int64)
        bufs = [np.arange(3 * N, dtype=np.float32) + i for i in range(N)]
        padded = tpvar.PVARS.lookup("vcoll_alltoallv_padded_elems")
        before = padded.read()
        trecv = tw.alltoallv(bufs, counts)
        _same_lists(jw.alltoallv(bufs, counts), trecv)
        assert padded.read() - before == N * N * 3
        for i in range(N):
            assert tuple(trecv[i].shape) == (3 * N,)
            np.testing.assert_array_equal(trecv[i][:3].numpy(),
                                          bufs[0][3 * i:3 * i + 3])


def test_payload_stays_on_the_device_tensors(worlds):
    """Tensor inputs are read in place: the caller's buffers keep their
    bits, and results are tensors on the comm's device."""
    _, tw = worlds
    c = _ragged_counts(N, seed=12, lo=1, hi=4)
    bufs = [torch.randn(int(c[i].sum())) for i in range(N)]
    before = [b.clone() for b in bufs]
    out = tw.alltoallv(bufs, c)
    assert all(o.device == tw.device for o in out)
    assert all(torch.equal(a, b) for a, b in zip(bufs, before))
    want = _mpi_alltoallv([b.numpy() for b in bufs], c)
    for o, w in zip(out, want):
        np.testing.assert_array_equal(o.numpy(), w)
