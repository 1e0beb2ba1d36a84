"""Topologies of the PyTorch port held against the JAX package:
``dims_create``, cart coords/rank/shift/sub, graph and dist-graph
neighbor lists, and every neighborhood collective (cart, graph,
dist-graph; blocking and ``ineighbor_*``) on the same numpy inputs.

The cases of ``tests/test_shmem_topo.py`` (TestDims, TestCart,
TestRaggedNeighborhoods, TestNonblockingNeighborhoods) run on both
packages; the neighborhood collectives move data only, so the port's
results are BITWISE the JAX package's.
"""

import numpy as np
import pytest

import ompi_release_tpu as jmpi
from ompi_release_tpu import topo as jtopo
from ompi_release_tpu.utils.errors import MPIError as JMPIError
import ompi_release_tpu_torch as tmpi
from ompi_release_tpu_torch import topo as ttopo
from ompi_release_tpu_torch.mca import var as tvar
from ompi_release_tpu_torch.runtime import runtime as trt
from ompi_release_tpu_torch.utils.errors import MPIError

N = 8


@pytest.fixture(scope="module")
def worlds():
    jworld = jmpi.init()
    trt._reset_for_tests()
    tworld = tmpi.init(cli_args=["--mca", "runtime_virtual_ranks", str(N)],
                       device="cpu")
    yield jworld, tworld
    trt._reset_for_tests()
    tvar.VARS.unset("runtime_virtual_ranks")


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy().dtype == np.asarray(want).dtype


def _ring_adjacency(n):
    index, edges, acc = [], [], 0
    for r in range(n):
        nbrs = [(r - 1) % n, (r + 1) % n]
        acc += len(nbrs)
        index.append(acc)
        edges.extend(nbrs)
    return index, edges


def _star_chord(n):
    """rank 0 sends to everyone; rank 3 also feeds rank 1."""
    destinations = [[r for r in range(1, n)]] + [[] for _ in range(n - 1)]
    destinations[3] = [1]
    sources = [[] for _ in range(n)]
    for r in range(1, n):
        sources[r] = [0]
    sources[1] = [0, 3]
    return sources, destinations


@pytest.mark.parametrize("args", [(8, 3, None), (12, 2, None), (8, 2, [2, 0]),
                                  (8, 2, [0, 0]), (6, 3, [0, 3, 0])])
def test_dims_create_matches_jax(args):
    assert ttopo.dims_create(*args) == jtopo.dims_create(*args)


def test_dims_create_rejects_like_jax():
    for bad in ((7, 2, [2, 0]), (8, 2, [2, 2])):
        with pytest.raises(JMPIError):
            jtopo.dims_create(*bad)
        with pytest.raises(MPIError):
            ttopo.dims_create(*bad)


@pytest.mark.parametrize("periods", [[True, False], [True, True],
                                     [False, False]])
def test_cart_queries_match_jax(worlds, periods):
    jw, tw = worlds
    jc, jt = jtopo.cart_create(jw, [2, 4], periods=periods)
    tc, tt = ttopo.cart_create(tw, [2, 4], periods=periods)
    try:
        assert tt.dims == jt.dims and tt.periods == jt.periods
        assert tc.topo is tt and tc.size == N
        for r in range(N):
            assert tt.coords(r) == jt.coords(r)
            assert tt.rank(tt.coords(r)) == r
            assert tt.neighbors(r) == jt.neighbors(r)
            for dim in (0, 1):
                for disp in (-1, 1, 2):
                    assert tt.shift(dim, disp, r) == jt.shift(dim, disp, r)
        assert tt.neighbor_perms() == jt.neighbor_perms()
    finally:
        jc.free()
        tc.free()


def test_cart_sub_matches_jax(worlds):
    jw, tw = worlds
    jc, jt = jtopo.cart_create(jw, [2, 4], periods=[False, False])
    tc, tt = ttopo.cart_create(tw, [2, 4], periods=[False, False])
    for keep in ([False, True], [True, False]):
        js, ts = jt.sub(keep), tt.sub(keep)
        assert len(ts) == N
        for r in range(N):
            assert ts[r][0].group.world_ranks == js[r][0].group.world_ranks
            assert ts[r][1].dims == js[r][1].dims
            assert ts[r][0].topo is ts[r][1]
    jc.free()
    tc.free()


def test_cart_dup_keeps_topology(worlds):
    _, tw = worlds
    tc, tt = ttopo.cart_create(tw, [4, 2], periods=[True, True])
    d = tc.dup()
    assert d.topo is tt
    d.free()
    tc.free()


@pytest.mark.parametrize("periods", [[True, True], [True, False],
                                     [False, False]])
@pytest.mark.parametrize("dims", [[2, 4], [4, 2], [8], [2, 2, 2]])
def test_cart_neighbor_collectives_bitwise(worlds, dims, periods):
    periods = (periods * 3)[:len(dims)]
    jw, tw = worlds
    jc, jt = jtopo.cart_create(jw, dims, periods=periods)
    tc, tt = ttopo.cart_create(tw, dims, periods=periods)
    try:
        rng = np.random.RandomState(len(dims) * 10 + sum(periods))
        x = rng.randn(N, 3).astype(np.float32)
        _eq(tt.neighbor_allgather(x), jt.neighbor_allgather(x))
        nn = 2 * len(dims)
        xa = rng.randint(-1000, 1000, (N, nn, 2)).astype(np.int32)
        _eq(tt.neighbor_alltoall(xa), jt.neighbor_alltoall(xa))
    finally:
        jc.free()
        tc.free()


def test_cart_neighbor_allgather_closed_form(worlds):
    """test_neighbor_allgather_2d_torus: slot order is neighbors()."""
    _, tw = worlds
    tc, tt = ttopo.cart_create(tw, [2, 4], periods=[True, True])
    x = np.arange(N, dtype=np.float32)[:, None]
    out = tt.neighbor_allgather(x).numpy()
    assert out.shape == (N, 4, 1)
    for r in range(N):
        np.testing.assert_array_equal(out[r, :, 0],
                                      np.array(tt.neighbors(r), np.float32))
    tc.free()


def test_cart_neighbor_alltoall_rejects_wrong_blocks(worlds):
    jw, tw = worlds
    jc, jt = jtopo.cart_create(jw, [2, 4], periods=[True, True])
    tc, tt = ttopo.cart_create(tw, [2, 4], periods=[True, True])
    x = np.zeros((N, 3, 1), np.float32)
    with pytest.raises(JMPIError):
        jt.neighbor_alltoall(x)
    with pytest.raises(MPIError):
        tt.neighbor_alltoall(x)
    jc.free()
    tc.free()


def test_graph_topo_matches_jax(worlds):
    jw, tw = worlds
    index, edges = _ring_adjacency(N)
    jg, jt = jtopo.graph_create(jw, index, edges)
    tg, tt = ttopo.graph_create(tw, index, edges)
    try:
        for r in range(N):
            assert tt.neighbors(r) == jt.neighbors(r)
        assert tt.max_degree == jt.max_degree == 2
        x = np.arange(N * 3, dtype=np.float32).reshape(N, 3)
        _eq(tt.neighbor_allgather(x), jt.neighbor_allgather(x))
        xa = np.arange(N * 2 * 2, dtype=np.float32).reshape(N, 2, 2)
        _eq(tt.neighbor_alltoall(xa), jt.neighbor_alltoall(xa))
    finally:
        jg.free()
        tg.free()


def test_irregular_graph_matches_jax(worlds):
    """A ragged symmetric graph (degrees 1-4): several edge-coloring
    rounds, unused slots zero."""
    jw, tw = worlds
    adj = [[1, 2, 3, 5], [0, 4], [0, 6], [0], [1, 7], [0, 6], [2, 5, 7],
           [4, 6]]
    index = list(np.cumsum([len(a) for a in adj]))
    edges = [e for a in adj for e in a]
    jg, jt = jtopo.graph_create(jw, index, edges)
    tg, tt = ttopo.graph_create(tw, index, edges)
    try:
        rng = np.random.RandomState(5)
        x = rng.randn(N, 2, 3).astype(np.float32)
        _eq(tt.neighbor_allgather(x), jt.neighbor_allgather(x))
        xa = rng.randn(N, 4, 3).astype(np.float32)
        _eq(tt.neighbor_alltoall(xa), jt.neighbor_alltoall(xa))
    finally:
        jg.free()
        tg.free()


def test_dist_graph_irregular_matches_jax(worlds):
    jw, tw = worlds
    sources, destinations = _star_chord(N)
    jd, jt = jtopo.dist_graph_create_adjacent(jw, sources, destinations)
    td, tt = ttopo.dist_graph_create_adjacent(tw, sources, destinations)
    try:
        assert (tt.max_in_degree, tt.max_out_degree) == (2, N - 1)
        for r in range(N):
            assert tt.in_neighbors(r) == jt.in_neighbors(r)
            assert tt.out_neighbors(r) == jt.out_neighbors(r)
        x = 10.0 + np.arange(N, dtype=np.float32).reshape(N, 1)
        out = tt.neighbor_allgather(x)
        _eq(out, jt.neighbor_allgather(x))
        np.testing.assert_array_equal(out[0].numpy(), np.zeros((2, 1)))
        xa = np.arange(N * (N - 1), dtype=np.float32).reshape(N, N - 1, 1)
        _eq(tt.neighbor_alltoall(xa), jt.neighbor_alltoall(xa))
    finally:
        jd.free()
        td.free()


def test_dist_graph_mismatched_edges_rejected(worlds):
    jw, tw = worlds
    sources = [[] for _ in range(N)]
    destinations = [[] for _ in range(N)]
    destinations[0] = [1]  # 0 sends to 1, but 1 lists no source
    with pytest.raises(JMPIError):
        jtopo.dist_graph_create_adjacent(jw, sources, destinations)
    with pytest.raises(MPIError):
        ttopo.dist_graph_create_adjacent(tw, sources, destinations)


def test_ineighbor_match_blocking(worlds):
    """TestNonblockingNeighborhoods on the port: the Request completes
    to the blocking call's result, and to JAX's."""
    jw, tw = worlds
    jc, jt = jtopo.cart_create(jw, [2, 4], periods=[True, True])
    tc, tt = ttopo.cart_create(tw, [2, 4], periods=[True, True])
    x = np.arange(N, dtype=np.float32)[:, None]
    req = tt.ineighbor_allgather(x)
    req.wait()
    assert req.test()[0]
    _eq(req.value, jt.neighbor_allgather(x))
    jc.free()
    tc.free()
    index, edges = _ring_adjacency(N)
    jg, jgt = jtopo.graph_create(jw, index, edges)
    tg, tgt = ttopo.graph_create(tw, index, edges)
    xa = np.random.RandomState(3).randn(N, 2, 3).astype(np.float32)
    req = tgt.ineighbor_alltoall(xa)
    req.wait()
    _eq(req.value, jgt.neighbor_alltoall(xa))
    jreq = jgt.ineighbor_alltoall(xa)
    jreq.wait()
    _eq(req.value, jreq.value)
    jg.free()
    tg.free()
