"""Intercommunicators of the PyTorch port held against the JAX package.

Every case of ``tests/test_intercomm.py`` but the ``comm/dpm.py`` ones
(connect/accept, name publishing, ports: ``tests/test_torch_dpm.py``)
runs on both packages on the same numpy inputs:
construction and validation, merge ordering, the inter-collectives
(blocking, nonblocking and ragged), p2p remote addressing and the
intra-only rejections. Data movement is bitwise; the reductions run the
same tuned algorithms on both sides (every comm of this module selects
``coll=tuned``), so they are bitwise too.
"""

import numpy as np
import pytest

import ompi_release_tpu as jmpi
from ompi_release_tpu.comm import intercomm_create as jcreate
from ompi_release_tpu.mca import var as jvar
from ompi_release_tpu.utils.errors import MPIError as JMPIError
import ompi_release_tpu_torch as tmpi
from ompi_release_tpu_torch.comm import Intercommunicator, intercomm_create
from ompi_release_tpu_torch.mca import var as tvar
from ompi_release_tpu_torch.runtime import runtime as trt
from ompi_release_tpu_torch.utils.errors import MPIError

N = 8
A, B = [0, 1, 2], [3, 4, 5, 6, 7]


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


@pytest.fixture(scope="module")
def pairs(worlds):
    """Two disjoint intra-comms on each side: A = ranks 0-2, B = 3-7."""
    out = []
    for w in worlds:
        out.append((w.create(w.group.incl(A), name="A"),
                    w.create(w.group.incl(B), name="B")))
    return out


@pytest.fixture
def inters(pairs):
    (ja, jb), (ta, tb) = pairs
    return jcreate(ja, 0, jb, 0), intercomm_create(ta, 0, tb, 0)


def _eq(got, want):
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_intercomm_create_shape(worlds, inters):
    _, tw = worlds
    (jia, jib), (ia, ib) = inters
    assert isinstance(ia, Intercommunicator)
    assert ia.is_inter and ib.is_inter and not tw.is_inter
    assert (ia.size, ia.remote_size) == (jia.size, jia.remote_size) == (3, 5)
    assert (ib.size, ib.remote_size) == (jib.size, jib.remote_size) == (5, 3)
    assert ia.mirror is ib and ib.mirror is ia
    assert ia.remote_group.world_ranks == jia.remote_group.world_ranks
    assert ia._bridge is ib._bridge
    assert ia._bridge.group.world_ranks == jia._bridge.group.world_ranks


def test_intercomm_groups_must_be_disjoint(worlds, pairs):
    (jw, tw), ((ja, _), (ta, _)) = worlds, pairs
    jo = jw.create(jw.group.incl([2, 3]), name="overlap")
    to = tw.create(tw.group.incl([2, 3]), name="overlap")
    with pytest.raises(JMPIError):
        jcreate(ja, 0, jo, 0)
    with pytest.raises(MPIError):
        intercomm_create(ta, 0, to, 0)


@pytest.mark.parametrize("leaders", [(5, 0), (0, 9), (-1, 0)])
def test_intercomm_leader_validation(pairs, leaders):
    (ja, jb), (ta, tb) = pairs
    with pytest.raises(JMPIError):
        jcreate(ja, leaders[0], jb, leaders[1])
    with pytest.raises(MPIError):
        intercomm_create(ta, leaders[0], tb, leaders[1])


def test_inter_allgather(inters):
    (jia, jib), (ia, ib) = inters
    bufs_a = np.arange(3 * 4, dtype=np.float32).reshape(3, 4)
    bufs_b = 100 + np.arange(5 * 4, dtype=np.float32).reshape(5, 4)
    got_a = ia.allgather(bufs_a, bufs_b)
    _eq(got_a, jia.allgather(bufs_a, bufs_b))
    _eq(got_a.reshape(5, 4), bufs_b)
    _eq(ib.allgather(bufs_b, bufs_a), jib.allgather(bufs_b, bufs_a))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_inter_allreduce_and_reduce(inters, dtype):
    (jia, jib), (ia, ib) = inters
    rng = np.random.RandomState(4)
    bufs_a = rng.randn(3, 6).astype(dtype) if dtype == np.float32 \
        else rng.randint(-50, 50, (3, 6)).astype(dtype)
    bufs_b = rng.randn(5, 6).astype(dtype) if dtype == np.float32 \
        else rng.randint(-50, 50, (5, 6)).astype(dtype)
    _eq(ia.allreduce(bufs_a, bufs_b), jia.allreduce(bufs_a, bufs_b))
    _eq(ib.allreduce(bufs_b, bufs_a), jib.allreduce(bufs_b, bufs_a))
    _eq(ia.reduce(bufs_b, root=1), jia.reduce(bufs_b, root=1))
    with pytest.raises(JMPIError):
        jia.reduce(bufs_b, root=3)
    with pytest.raises(MPIError):
        ia.reduce(bufs_b, root=3)  # root must be in LOCAL group (size 3)


def test_inter_bcast_scatter_gather(inters):
    (jia, _), (ia, _) = inters
    x = np.arange(6, dtype=np.float32)
    _eq(ia.bcast(x, root=2), jia.bcast(x, root=2))
    with pytest.raises(MPIError):
        ia.bcast(x, root=7)
    bufs_b = np.arange(5 * 3, dtype=np.float32).reshape(5, 3)
    _eq(ia.gather(bufs_b, root=0), jia.gather(bufs_b, root=0))
    with pytest.raises(MPIError):
        ia.gather(bufs_b, root=3)
    sendbuf = np.arange(3 * 2, dtype=np.float32).reshape(3, 2)
    got = ia.scatter(sendbuf, root=0)
    _eq(got, jia.scatter(sendbuf, root=0))
    _eq(got, sendbuf)
    with pytest.raises(MPIError):
        ia.scatter(np.zeros((4, 2), np.float32), root=0)


def test_inter_alltoall(inters):
    (jia, jib), (ia, ib) = inters
    send_a = np.arange(3 * 5, dtype=np.int32).reshape(3, 5)
    send_b = 100 + np.arange(5 * 3, dtype=np.int32).reshape(5, 3)
    got_a = ia.alltoall(send_a, send_b)
    _eq(got_a, jia.alltoall(send_a, send_b))
    _eq(got_a, send_b.T)
    _eq(ib.alltoall(send_b, send_a), jib.alltoall(send_b, send_a))
    # chunks wider than one element
    wa = np.arange(3 * 5 * 2, dtype=np.float32).reshape(3, 5, 2)
    wb = -np.arange(5 * 3 * 2, dtype=np.float32).reshape(5, 3, 2)
    _eq(ia.alltoall(wa, wb), jia.alltoall(wa, wb))
    with pytest.raises(MPIError):
        ia.alltoall(send_b, send_a)
    ia.barrier()


def test_intra_only_ops_rejected(inters):
    _, (ia, _) = inters
    for fn in (ia.scan, ia.exscan, ia.split, ia.iscan, ia.iexscan):
        with pytest.raises(MPIError):
            fn(np.zeros((3, 4), np.float32))


def test_intercomm_merge_ordering(inters):
    (jia, _), (ia, _) = inters
    low, jlow = ia.merge(high=False), jia.merge(high=False)
    assert not low.is_inter
    assert low.group.world_ranks == jlow.group.world_ranks \
        == (0, 1, 2, 3, 4, 5, 6, 7)
    high, jhigh = ia.merge(high=True), jia.merge(high=True)
    assert high.group.world_ranks == jhigh.group.world_ranks \
        == (3, 4, 5, 6, 7, 0, 1, 2)
    x = np.random.RandomState(8).randn(8, 2).astype(np.float32)
    _eq(low.allreduce(x), jlow.allreduce(x))
    _eq(high.allreduce(x), jhigh.allreduce(x))


def test_inter_nonblocking_variants(inters):
    (jia, _), (ia, _) = inters
    bufs_a = np.arange(3, dtype=np.float32).reshape(3, 1)
    bufs_b = 10 + np.arange(5, dtype=np.float32).reshape(5, 1)
    cases = [
        ("iallgather", (bufs_a, bufs_b), "allgather"),
        ("iallreduce", (bufs_a, bufs_b), "allreduce"),
        ("ibcast", (np.arange(4, dtype=np.float32), 1), "bcast"),
        ("ireduce", (bufs_b,), "reduce"),
        ("igather", (bufs_b,), "gather"),
        ("iscatter", (np.arange(3 * 2, dtype=np.float32).reshape(3, 2), 0),
         "scatter"),
        ("ialltoall", (np.arange(15, dtype=np.float32).reshape(3, 5),
                       np.arange(15, dtype=np.float32).reshape(5, 3)),
         "alltoall"),
        ("ireduce_scatter_block",
         (np.arange(5 * 6, dtype=np.float32).reshape(5, 6),),
         "reduce_scatter_block"),
    ]
    for iname, args, bname in cases:
        req = getattr(ia, iname)(*args)
        req.wait()
        assert req.test()[0], iname
        _eq(req.value, getattr(jia, bname)(*args))
    rb = ia.ibarrier()
    rb.wait()
    assert rb.test()[0]


def test_inter_v_variants(inters):
    """The ragged inter collectives (MPI-2.2 inter semantics: results land
    in the group complementary to the contributors)."""
    (jia, _), (ia, _) = inters
    nl, nr = ia.size, ia.remote_size
    send_b = [np.arange(j + 1, dtype=np.float32) + 10 * j
              for j in range(nr)]
    send_a = [np.arange(2, dtype=np.float32) for _ in range(nl)]
    _eq(ia.allgatherv(send_a, send_b), jia.allgatherv(send_a, send_b))
    _eq(ia.gatherv(send_b, root=1), jia.gatherv(send_b, root=1))

    counts = [2, 1, 3]
    buf = np.arange(6, dtype=np.float32)
    out, jout = ia.scatterv(buf, counts, root=2), \
        jia.scatterv(buf, counts, root=2)
    for a, b in zip(out, jout):
        _eq(a, b)

    xs = np.stack([np.arange(6, dtype=np.float32) * (j + 1)
                   for j in range(nr)])
    rsb = ia.reduce_scatter_block(xs)
    assert rsb.shape[0] == nl
    _eq(rsb, jia.reduce_scatter_block(xs))
    with pytest.raises(MPIError):
        ia.reduce_scatter_block(np.ones((nr, 4), np.float32))

    rc = [1, 2, 3]
    for a, b in zip(ia.reduce_scatter(xs, rc), jia.reduce_scatter(xs, rc)):
        _eq(a, b)
    with pytest.raises(MPIError):
        ia.reduce_scatter(xs, [1, 2, 2])

    cl = np.asarray([[(i + j) % 2 for j in range(nr)] for i in range(nl)])
    cr = np.asarray([[(j + 2 * i) % 3 for i in range(nl)]
                     for j in range(nr)])
    sb_l = [np.full(int(cl[i].sum()), float(i), np.float32)
            for i in range(nl)]
    sb_r = [np.concatenate([np.full(int(cr[j, i]), 100 * j + i,
                                    np.float32) for i in range(nl)])
            for j in range(nr)]
    for a, b in zip(ia.alltoallv(sb_l, cl, sb_r, cr),
                    jia.alltoallv(sb_l, cl, sb_r, cr)):
        _eq(a, b)
    with pytest.raises(MPIError):
        ia.alltoallv(sb_l, cl, sb_r, -cr)

    for iname, args in (("iallgatherv", (send_a, send_b)),
                        ("igatherv", (send_b, 1))):
        req = getattr(ia, iname)(*args)
        req.wait()
        _eq(req.value, getattr(jia, iname[1:])(*args))
    for iname, args in (("iscatterv", (buf, counts, 2)),
                        ("ireduce_scatter", (xs, rc)),
                        ("ialltoallv", (sb_l, cl, sb_r, cr))):
        req = getattr(ia, iname)(*args)
        req.wait()
        for a, b in zip(req.value, getattr(jia, iname[1:])(*args)):
            _eq(a, b)
    req = ia.ireduce_scatter_block(xs)
    req.wait()
    _eq(req.value, jia.reduce_scatter_block(xs))


def test_inter_p2p_remote_addressing(inters):
    """dest/source are ranks in the REMOTE group: A's rank 0 -> remote
    rank 1 lands at B's local rank 1 (world rank 4); status.source is the
    remote-group rank, as in the JAX package."""
    (jia, jib), (ia, ib) = inters
    payload = np.arange(5, dtype=np.float32)
    for a, b in ((ia, ib), (jia, jib)):
        req = a.isend(payload, dest=1, tag=7, rank=0)
        got, st = b.recv(source=0, tag=7, rank=1)
        req.wait()
        _eq(got, payload)
        assert st.source == 0
        b.send(payload, dest=2, tag=9, rank=3)  # B rank 3 -> A rank 2
        _, st3 = a.recv(source=-1, tag=9, rank=2)
        assert st3.source == 3  # remote (B-group) rank, not bridge rank 6
        b.send(payload * 2, dest=0, tag=8, rank=1)
        got2, _ = a.recv(source=1, tag=8, rank=0)
        _eq(got2, payload * 2)
    rq = ia.irecv(source=4, tag=11, rank=1)
    ib.send(payload + 1, dest=1, tag=11, rank=4)
    rq.wait()
    _eq(rq.value, payload + 1)
    assert rq.status.source == 4
    with pytest.raises(MPIError):
        ia.isend(payload, dest=5, rank=0)  # remote group has 5 ranks 0-4
    with pytest.raises(MPIError):
        ia.isend(payload, dest=0, rank=3)  # local group has 3 ranks
    with pytest.raises(MPIError):
        ia.sendrecv([payload], [0])
