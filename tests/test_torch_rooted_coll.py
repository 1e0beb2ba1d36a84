"""Rooted and scan collectives of the PyTorch port held against the JAX
package: gather, scatter, scan and exscan (and the pair-op rooted
calls of ``tests/test_coll.py``).

The same rank-stacked inputs, made from a numpy seed, go through
``ompi_release_tpu`` on its 8-device virtual CPU mesh and through
``ompi_release_tpu_torch`` with 8 virtual ranks on the CPU. Tuned's
named gather/scatter algorithms and its recursive-doubling scan fix
their order of operations, and the port keeps it (the scan folds
``op(recv, acc)`` in the same rounds; binomial gather/scatter merge
``cur + recv`` as the reference does): results are BITWISE equal. The
fused scan folds in ``lax.associative_scan``'s order
(:func:`spmd.associative_scan`): it is held bitwise to that order
written out on the host, within rtol=1e-6 of JAX's result, and in
fact value-exact to it on the CPU (XLA keeps ``associative_scan``'s
combine order there; only the sign of a zero may differ).
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
from ompi_release_tpu_torch.coll import spmd as tspmd
from ompi_release_tpu_torch.mca import var as tvar
from ompi_release_tpu_torch.runtime import runtime as trt

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
    assert jworld.size == tworld.size == N
    yield jworld, tworld
    trt._reset_for_tests()
    tvar.VARS.unset("runtime_virtual_ranks")


@pytest.fixture(scope="module")
def tuned(worlds):
    jworld, tworld = worlds
    with both(coll="tuned"):
        jc = jworld.dup(name="rooted_tuned")
        tc = tworld.dup(name="rooted_tuned")
    yield jc, tc
    jc.free()
    tc.free()


@pytest.fixture(scope="module")
def tuned5(worlds):
    """A non-power-of-two tuned comm: ranks 0-4."""
    jworld, tworld = worlds
    with both(coll="tuned"):
        jc = jworld.create(jworld.group.incl([0, 1, 2, 3, 4]), name="t5")
        tc = tworld.create(tworld.group.incl([0, 1, 2, 3, 4]), name="t5")
    yield jc, tc
    jc.free()
    tc.free()


def _inputs(n, count, seed=7, signed_zero=True):
    """f32 values spanning magnitudes (order shows in the low bits),
    with a -0.0 and an exact zero among them."""
    rng = np.random.default_rng(seed)
    scale = rng.uniform(-6, 6, size=(n, count)).astype(np.float32)
    x = (rng.normal(size=(n, count)).astype(np.float32)
         * np.exp2(scale).astype(np.float32))
    if signed_zero:
        x[0, 0] = -0.0
        x[n - 1, count - 1] = -0.0
        x[n // 2, 1] = 0.0
    return x


def _bits_equal(jout, tout):
    j = np.asarray(jout)
    t = tout.detach().cpu().numpy()
    assert j.shape == t.shape and j.dtype.itemsize == t.dtype.itemsize
    uint = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[
        j.dtype.itemsize]
    np.testing.assert_array_equal(j.view(uint), t.view(uint))


def _pair(jpair, tpair):
    for j, t in zip(jpair, tpair):
        _bits_equal(j, t)


# ---------------------------------------------------------------------------
# gather / scatter
# ---------------------------------------------------------------------------

def test_gather_scatter(worlds):
    """Fused (xla) gather and scatter: root keeps the concatenation,
    other ranks zeros; each rank gets its chunk of root's buffer."""
    jw, tw = worlds
    x = _inputs(N, 10, seed=19)
    for root in (0, 1, 5):
        _bits_equal(jw.gather(x, root=root), tw.gather(x, root=root))
        big = _inputs(N, N * 5, seed=20 + root)
        _bits_equal(jw.scatter(big, root=root), tw.scatter(big, root=root))
    g = tw.gather(torch.from_numpy(x), root=1)
    assert torch.equal(g[1], torch.from_numpy(x).reshape(-1))
    assert bool((g[0] == 0).all())


@pytest.mark.parametrize("alg", ["binomial", "linear"])
@pytest.mark.parametrize("root", [0, 3, 5])
def test_tuned_gather_scatter_algorithms(tuned, alg, root):
    jc, tc = tuned
    x = _inputs(N, 6, seed=51 + root)
    with both(coll_tuned_gather_algorithm=alg):
        jg, tg = jc.gather(x, root=root), tc.gather(x, root=root)
    assert ("tuned", "gather", alg, root) in tc._coll_programs
    _bits_equal(jg, tg)
    assert torch.equal(tg[root], torch.from_numpy(x).reshape(-1))
    big = _inputs(N, N * 5, seed=52 + root)
    with both(coll_tuned_scatter_algorithm=alg):
        js, ts = jc.scatter(big, root=root), tc.scatter(big, root=root)
    assert ("tuned", "scatter", alg, root) in tc._coll_programs
    _bits_equal(js, ts)


def test_binomial_merge_turns_negative_zero_positive(tuned):
    """The binomial trees merge received blocks as ``cur + recv``: a
    -0.0 that traveled lands as +0.0, in both packages alike; root's
    own block keeps its -0.0."""
    jc, tc = tuned
    x = np.ones((N, 2), np.float32)
    x[:, 0] = -0.0
    with both(coll_tuned_gather_algorithm="binomial"):
        tg = tc.gather(x, root=0)
        _bits_equal(jc.gather(x, root=0), tg)
    signs = torch.signbit(tg[0].reshape(N, 2)[:, 0])
    assert bool(signs[0]) and not bool(signs[1:].any())


def test_tuned_gather_scatter_non_power_of_two(tuned5):
    jc, tc = tuned5
    x = _inputs(5, 4, seed=53)
    big = _inputs(5, 5 * 3, seed=54)
    with both(coll_tuned_gather_algorithm="binomial",
              coll_tuned_scatter_algorithm="binomial"):
        for root in (0, 2, 4):
            _bits_equal(jc.gather(x, root=root), tc.gather(x, root=root))
            _bits_equal(jc.scatter(big, root=root),
                        tc.scatter(big, root=root))
    g = tc.gather(x, root=4)
    assert torch.equal(g[4], torch.from_numpy(x).reshape(-1))


def test_basic_gather_scatter(worlds):
    jw, tw = worlds
    with both(coll="basic,self"):
        jc, tc = jw.dup(name="basic_gs"), tw.dup(name="basic_gs")
    try:
        assert tc._coll_providers["gather"] == ["basic"]
        x = _inputs(N, 7, seed=60)
        _bits_equal(jc.gather(x, root=2), tc.gather(x, root=2))
        big = _inputs(N, N * 3, seed=61)
        _bits_equal(jc.scatter(big, root=6), tc.scatter(big, root=6))
        assert ("basic", "scatter", 6) in tc._coll_programs
    finally:
        jc.free()
        tc.free()


def test_gather_scatter_decision_rules(worlds):
    """gather/scatter_intra_dec_fixed picks, the same in both packages
    on comms of 8 and 16 ranks' worth of sizes."""
    from ompi_release_tpu.coll.components import _TunedModule as JTuned
    from ompi_release_tpu_torch.coll.components import _TunedModule as TTuned

    jw, tw = worlds
    jm, tm = JTuned(jw), TTuned(tw)
    for count in (1, 100, 250, 1500, 1501, 100_000):
        a = np.zeros((N, count), np.float32)
        assert tm._pick_gather(torch.from_numpy(a)) == jm._pick_gather(a)
        assert tm._pick_scatter(torch.from_numpy(a)) == jm._pick_scatter(a)
    assert tm._pick_gather(torch.zeros(N, 2000)) == "linear"


# ---------------------------------------------------------------------------
# scan / exscan
# ---------------------------------------------------------------------------

def _positive(n, count, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 2.0, size=(n, count))
            * np.exp2(rng.uniform(-6, 6, size=(n, count)))).astype(np.float32)


def _host_associative_scan(x):
    """``lax.associative_scan``'s combine order, on the host in f32."""
    def scan(el):
        m = el.shape[0]
        if m < 2:
            return el
        odd = scan((el[0:m - 1:2] + el[1::2]).astype(np.float32))
        if m % 2 == 0:
            even = odd[:-1] + el[2::2]
        else:
            even = odd + el[2::2]
        even = np.concatenate([el[0:1], even.astype(np.float32)])
        out = np.empty_like(el)
        out[0::2] = even
        out[1::2] = odd
        return out
    return scan(x)


def test_scan_exscan(worlds):
    """The fused scan: bitwise to associative_scan's order written out
    on the host, within rtol 1e-6 of JAX's; exscan's rank 0 is zeros."""
    jw, tw = worlds
    x = _positive(N, 20, seed=37)
    out = tw.scan(x, tops.SUM)
    np.testing.assert_array_equal(out.numpy(), _host_associative_scan(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jw.scan(x, jops.SUM)),
                               rtol=1e-6, atol=0)
    ex = tw.exscan(x, tops.SUM)
    assert bool((ex[0] == 0).all())
    np.testing.assert_array_equal(ex[1:].numpy(), out[:-1].numpy())
    np.testing.assert_allclose(ex.numpy(), np.asarray(jw.exscan(x, jops.SUM)),
                               rtol=1e-6, atol=0)
    # mixed signs: every value exactly JAX's. Only the sign of a zero
    # may differ: JAX's all_gather on the CPU turns rank 0's -0.0 into
    # +0.0, the port's gather moves it untouched
    mixed = _inputs(N, 300, seed=39)
    for name, jop, top in (("scan", jops.SUM, tops.SUM),
                           ("exscan", jops.SUM, tops.SUM)):
        np.testing.assert_array_equal(
            np.asarray(getattr(jw, name)(mixed, jop)),
            getattr(tw, name)(mixed, top).numpy())
    assert ("fused", "scan", tops.SUM, False) in tw._coll_programs


@pytest.mark.parametrize("n", [1, 2, 3, 5, 6, 7, 8])
def test_associative_scan_order_any_length(n):
    x = _positive(n, 9, seed=n)
    got = tspmd.associative_scan(torch.from_numpy(x), tops.SUM)
    np.testing.assert_array_equal(got.numpy(), _host_associative_scan(x))


def test_scan_exscan_pair_ops(worlds):
    """MPI_Scan/Exscan with MINLOC/MAXLOC: running argmax/argmin with
    MPI's lowest-index tie-break; rank 0's exscan slice is zeros."""
    jw, tw = worlds
    vals = np.asarray([3., 1., 7., 2., 9., 0., 7., 4.],
                      np.float32).reshape(-1, 1)
    idxs = np.arange(N, dtype=np.int32).reshape(-1, 1)
    for op_name in ("MAXLOC", "MINLOC"):
        jop, top = getattr(jops, op_name), getattr(tops, op_name)
        _pair(jw.scan((vals, idxs), jop), tw.scan((vals, idxs), top))
        _pair(jw.exscan((vals, idxs), jop), tw.exscan((vals, idxs), top))
    sv, si = tw.scan((vals, idxs), tops.MAXLOC)
    assert sv.reshape(-1).tolist() == [3, 3, 7, 7, 9, 9, 9, 9]
    assert si.reshape(-1).tolist() == [0, 0, 2, 2, 4, 4, 4, 4]


def test_scan_tuned(tuned):
    """Tuned's recursive-doubling scan and exscan: bitwise equal to
    JAX's (the same rounds, ``op(recv, acc)``), in f32 with mixed signs
    and for a noncommutative user op."""
    jc, tc = tuned
    x = _inputs(N, 20, seed=38)
    _bits_equal(jc.scan(x, jops.SUM), tc.scan(x, tops.SUM))
    _bits_equal(jc.exscan(x, jops.SUM), tc.exscan(x, tops.SUM))
    assert ("tuned", "scan", tops.SUM) in tc._coll_programs
    assert ("tuned", "exscan", tops.SUM) in tc._coll_programs
    jleft = jops.user_op("lin", lambda a, b: a * 0.5 + b, commute=False)
    tleft = tops.user_op("lin", lambda a, b: a * 0.5 + b, commute=False)
    _bits_equal(jc.scan(x, jleft), tc.scan(x, tleft))
    ints = np.random.default_rng(3).integers(-50, 50, (N, 33)).astype(
        np.float32)
    assert torch.equal(tc.scan(ints), torch.cumsum(torch.from_numpy(ints), 0))


def test_fused_scan_defers_to_tuned_past_gather_limit(worlds):
    """Above coll_xla_scan_gather_limit per rank the fused scan declines
    and tuned's recursive doubling takes the call."""
    jw, tw = worlds
    big = np.ones((N, 300_000), np.float32)  # 1.2 MB per rank
    out = tw.scan(big)
    np.testing.assert_array_equal(out[3].numpy(), 4 * big[0])
    assert any(k[:2] == ("tuned", "scan") for k in tw._coll_programs)
    with both(coll_xla_scan_gather_limit=4):
        x = _inputs(N, 8, seed=40)
        _bits_equal(jw.scan(x), tw.scan(x))
        assert any(k[:2] == ("tuned", "scan") for k in jw._coll_programs)


# ---------------------------------------------------------------------------
# pair ops on the rooted/block calls
# ---------------------------------------------------------------------------

def test_reduce_and_rsb_pair_ops(worlds):
    """Rooted MPI_Reduce with MAXLOC and reduce_scatter_block with
    MINLOC, bitwise against JAX."""
    jw, tw = worlds
    vals = np.asarray([3., 1., 7., 2., 9., 0., 7., 4.],
                      np.float32).reshape(N, 1)
    idxs = np.arange(N, dtype=np.int32).reshape(N, 1)
    _pair(jw.reduce((vals, idxs), jops.MAXLOC, root=2),
          tw.reduce((vals, idxs), tops.MAXLOC, root=2))
    vs = np.stack([np.roll(np.arange(N, dtype=np.float32), r)
                   for r in range(N)])
    ix = np.tile(np.arange(N, dtype=np.int32).reshape(N, 1), (1, N))
    tv, ti = tw.reduce_scatter_block((vs, ix), tops.MINLOC)
    _pair(jw.reduce_scatter_block((vs, ix), jops.MINLOC), (tv, ti))
    for r in range(N):
        assert int(ti[r, 0]) == int(np.argmin(vs[:, r]))


def test_general_reduce_scatter_pair_op(worlds):
    jw, tw = worlds
    vals = np.stack([np.roll(np.arange(10, dtype=np.float32), r)
                     for r in range(N)])
    idxs = np.zeros((N, 10), np.int32) + np.arange(N, dtype=np.int32)[:, None]
    rc = [1, 2, 1, 2, 1, 1, 1, 1]
    jout = jw.reduce_scatter((vals, idxs), rc, jops.MINLOC)
    tout = tw.reduce_scatter((vals, idxs), rc, tops.MINLOC)
    for jp, tp in zip(jout, tout):
        _pair(jp, tp)


def test_float64_travels_as_float64(worlds, tuned):
    """The JAX package refuses 64-bit buffers (x64 off: they would
    narrow); the port carries MPI_DOUBLE at 8 bytes end to end."""
    jw, tw = worlds
    _, tc = tuned
    x = np.random.default_rng(1).normal(size=(N, 6))
    g = tw.gather(x, root=3)
    assert g.dtype == torch.float64
    np.testing.assert_array_equal(g[3].numpy(), x.reshape(-1))
    s = tc.scan(x)
    assert s.dtype == torch.float64
    np.testing.assert_allclose(s.numpy(), np.cumsum(x, axis=0), rtol=1e-12)
    from ompi_release_tpu.utils.errors import MPIError as JMPIError

    with pytest.raises(JMPIError, match="narrowed"):
        jw.allreduce(x)


def test_self_comm_rooted_and_scan(worlds):
    jw, tw = worlds
    jsub = jw.create(jw.group.incl([0]), name="solo_r")
    tsub = tw.create(tw.group.incl([0]), name="solo_r")
    try:
        x = np.arange(5, dtype=np.float32).reshape(1, 5)
        for name in ("gather", "scatter"):
            _bits_equal(getattr(jsub, name)(x, root=0),
                        getattr(tsub, name)(x, root=0))
        _bits_equal(jsub.scan(x), tsub.scan(x))
        _bits_equal(jsub.exscan(x), tsub.exscan(x))
    finally:
        jsub.free()
        tsub.free()
