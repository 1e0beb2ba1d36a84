"""The ``ml`` component (two-level hierarchical collectives) of the
PyTorch port held against the JAX package, at a forced hierarchy of
2 nodes x 4 ranks (``coll_ml_local_size=4``, ``coll=ml,basic``).

Each case of ``TestHierarchicalMl`` in ``tests/test_coll.py`` runs on
both packages with the same numpy inputs. At 2 x 4 the only inter-node
step of a reduction is ONE commutative combine and the intra-node step
is the ring reduce-scatter, whose order both packages fix: results are
BITWISE equal, the accelerated SUM resolved in both
(``op_pallas_threshold`` / ``op_cuda_threshold`` lowered) and not.
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


@contextlib.contextmanager
def accelerated_sum(threshold=1024):
    jvar.set_value("op_pallas_threshold", threshold)
    tvar.set_value("op_cuda_threshold", threshold)
    try:
        yield
    finally:
        jvar.VARS.unset("op_pallas_threshold")
        tvar.VARS.unset("op_cuda_threshold")


@pytest.fixture(scope="module")
def worlds():
    jworld = jmpi.init()
    trt._reset_for_tests()
    tworld = tmpi.init(cli_args=["--mca", "runtime_virtual_ranks", str(N)],
                       device="cpu")
    yield jworld, tworld
    trt._reset_for_tests()
    tvar.VARS.unset("runtime_virtual_ranks")


@pytest.fixture()
def ml(worlds):
    jworld, tworld = worlds
    with both(coll_ml_local_size=4):
        with both(coll="ml,basic"):  # basic backfills the rest
            jc, tc = jworld.dup(name="ml_dup"), tworld.dup(name="ml_dup")
        yield jc, tc
    jc.free()
    tc.free()


def _per_rank(count, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, count))
            * np.exp2(rng.uniform(-6, 6, size=(N, count)))).astype(dtype)


def _same(jout, tout):
    j = np.asarray(jout)
    t = tout.detach().cpu().numpy()
    assert j.shape == t.shape and j.dtype.itemsize == t.dtype.itemsize
    uint = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[
        j.dtype.itemsize]
    np.testing.assert_array_equal(j.view(uint), t.view(uint))


def test_ml_selected_for_allreduce(ml):
    jc, tc = ml
    assert tc._coll_providers["allreduce"][0] == "ml"
    assert tc._coll_providers == {
        k: v for k, v in jc._coll_providers.items()
        if k in tc._coll_providers}


@pytest.mark.parametrize("accel", [False, True])
def test_two_level_allreduce_parity(ml, accel):
    jc, tc = ml
    x = _per_rank(1000, seed=51)
    ctx = accelerated_sum() if accel else contextlib.nullcontext()
    with ctx:
        tout = tc.allreduce(x, tops.SUM)
        _same(jc.allreduce(x, jops.SUM), tout)
    keys = [k for k in tc._coll_programs if k[0] == "ml"]
    assert keys and keys[-1][1] == "allreduce"
    assert (keys[-1][2].name == "sum[cuda]") == accel
    np.testing.assert_allclose(tout[3].numpy(), x.sum(axis=0), rtol=2e-5,
                               atol=1e-4)


def test_two_level_allreduce_nondivisible(ml):
    jc, tc = ml
    x = _per_rank(37, seed=52)  # 37 % 4 != 0: the padding path
    tout = tc.allreduce(x, tops.MAX)
    _same(jc.allreduce(x, jops.MAX), tout)
    np.testing.assert_array_equal(tout[0].numpy(), x.max(axis=0))


def test_two_level_bcast(ml):
    jc, tc = ml
    x = _per_rank(64, seed=53)
    tout = tc.bcast(x, root=5)
    _same(jc.bcast(x, root=5), tout)
    for r in range(N):
        np.testing.assert_array_equal(tout[r].numpy(), x[5])


def test_two_level_reduce(ml):
    jc, tc = ml
    x = _per_rank(48, seed=55)
    tout = tc.reduce(x, tops.SUM, root=3)
    _same(jc.reduce(x, jops.SUM, root=3), tout)
    mask = np.ones(N, bool)
    mask[3] = False
    assert (tout.numpy()[mask] == 0).all()
    assert any(k[:2] == ("ml", "reduce") for k in tc._coll_programs)


def test_two_level_allgather(ml):
    jc, tc = ml
    x = _per_rank(24, seed=56)
    tout = tc.allgather(x)
    _same(jc.allgather(x), tout)
    for r in range(N):
        np.testing.assert_array_equal(tout[r].numpy(), x.reshape(-1))
    assert any(k[:2] == ("ml", "allgather") for k in tc._coll_programs)


def test_two_level_reduce_scatter_block(ml):
    jc, tc = ml
    x = _per_rank(N * 6, seed=57)
    tout = tc.reduce_scatter_block(x, tops.SUM)
    _same(jc.reduce_scatter_block(x, jops.SUM), tout)
    assert any(k[:2] == ("ml", "reduce_scatter_block")
               for k in tc._coll_programs)


def test_two_level_alltoall(ml):
    jc, tc = ml
    x = np.stack([np.asarray([i * 100 + j for j in range(N)], np.int32)
                  for i in range(N)])
    tout = tc.alltoall(x)
    _same(jc.alltoall(x), tout)
    for i in range(N):
        np.testing.assert_array_equal(
            tout[i].numpy(), np.asarray([s * 100 + i for s in range(N)]))
    assert any(k[:2] == ("ml", "alltoall") for k in tc._coll_programs)
    y = _per_rank(N * 3, seed=58)  # blocks of 3 elements
    _same(jc.alltoall(y), tc.alltoall(y))


def test_xla_scan_defers_to_tuned_past_gather_limit(worlds):
    jw, tw = worlds
    big = np.ones((N, 300_000), np.float32)  # 1.2 MB per rank
    out = tw.scan(big)
    np.testing.assert_allclose(out[3].numpy(), 4 * big[0], rtol=1e-6)
    assert any(k[:2] == ("tuned", "scan") for k in tw._coll_programs)


def test_ml_declines_noncommutative(ml):
    jc, tc = ml
    jleft = jops.user_op("left", lambda a, b: a, commute=False)
    tleft = tops.user_op("left", lambda a, b: a, commute=False)
    x = _per_rank(16, seed=54)
    tout = tc.allreduce(x, tleft)  # falls through to basic
    _same(jc.allreduce(x, jleft), tout)
    np.testing.assert_array_equal(tout[0].numpy(), x[0])
    assert not any(k[0] == "ml" and k[2] is tleft for k in tc._coll_programs)


def test_ml_declines_without_hierarchy(worlds):
    """No forced local size and every rank in one process: ml must not
    claim the comm."""
    _, tw = worlds
    tvar.set_value("coll", "ml,basic")
    try:
        c = tw.dup(name="no_ml")
    finally:
        tvar.VARS.unset("coll")
    assert c._coll_providers["allreduce"] == ["basic"]
    c.free()


def test_ml_barrier(ml):
    _, tc = ml
    tc.barrier()
    assert any(k[:2] == ("ml", "barrier") for k in tc._coll_programs)


def test_ml_4x2_and_integer_sums(worlds):
    """Another factorization (4 nodes x 2): integer-valued sums are
    exact, so the two-level result is the plain sum bitwise."""
    _, tw = worlds
    with both(coll_ml_local_size=2):
        tvar.set_value("coll", "ml,basic")
        try:
            c = tw.dup(name="ml42")
        finally:
            tvar.VARS.unset("coll")
    try:
        x = torch.from_numpy(np.random.default_rng(4).integers(
            -99, 99, (N, 50)).astype(np.float32))
        assert torch.equal(c.allreduce(x)[6], x.sum(0))
        assert any(k[-2:] == (4, 2) for k in c._coll_programs)
    finally:
        c.free()
