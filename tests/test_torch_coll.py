"""Collectives of the PyTorch port held against the JAX package.

The same rank-stacked inputs, made from a numpy seed, go through
``ompi_release_tpu`` on its 8-device virtual CPU mesh and through
``ompi_release_tpu_torch`` with 8 virtual ranks on the CPU. Each named
tuned algorithm is forced in both packages, with the accelerated SUM
resolved in both (``op_pallas_threshold`` / ``op_cuda_threshold``
lowered below the test sizes), and the results must be BITWISE equal:
every algorithm fixes its own f32 summation order, the port keeps that
order, and the SUM combiner is one IEEE add in both (Pallas interpret
mode there, the kernel's plain twin here).

The ``fused`` component (the ``xla`` counterpart) folds in its own
declared order; it is held bitwise to that order and within rtol=1e-6
of JAX's ``psum``, whose order XLA does not define (inputs positive, so
no cancellation: 8 terms of relative error 2^-24 each stay below 1e-6).
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
COUNT = 1001  # per rank: not a multiple of the rank count (ring padding)


@contextlib.contextmanager
def both(**kv):
    """Set cvars in both packages' registries for the block."""
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
    """Lower both accelerated-SUM thresholds below the test sizes."""
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
    assert jworld.size == tworld.size == N
    yield jworld, tworld
    trt._reset_for_tests()
    tvar.VARS.unset("runtime_virtual_ranks")


def _tuned_dup(jworld, tworld):
    with both(coll="tuned"):
        jc = jworld.dup(name="torch_parity_tuned")
        tc = tworld.dup(name="torch_parity_tuned")
    assert jc._coll_providers["allreduce"] == ["tuned"]
    assert tc._coll_providers["allreduce"] == ["tuned"]
    return jc, tc


@pytest.fixture(scope="module")
def tuned(worlds):
    jc, tc = _tuned_dup(*worlds)
    yield jc, tc
    jc.free()
    tc.free()


@pytest.fixture(scope="module")
def tuned6(worlds):
    """A non-power-of-two tuned comm (6 ranks) from split."""
    jworld, tworld = worlds
    colors = [0] * 6 + [1] * 2
    with both(coll="tuned"):
        jparts = jworld.split(colors)
        tparts = tworld.split(colors)
    jc, tc = jparts[0], tparts[0]
    assert jc.size == tc.size == 6
    yield jc, tc
    for c in (jparts[0], jparts[-1], tparts[0], tparts[-1]):
        c.free()


def _inputs(n, count, seed=7):
    """f32 values spanning magnitudes, so the reduction order shows in
    the low mantissa bits."""
    rng = np.random.default_rng(seed)
    scale = rng.uniform(-6, 6, size=(n, count)).astype(np.float32)
    return (rng.normal(size=(n, count)).astype(np.float32)
            * np.exp2(scale).astype(np.float32))


def _bits_equal(jout, tout):
    j = np.asarray(jout)
    if tout.dtype is torch.bfloat16:  # numpy has no bfloat16: compare bits
        tout = tout.view(torch.int16)
    t = tout.numpy()
    assert j.shape == t.shape and j.dtype.itemsize == t.dtype.itemsize
    uint = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[
        j.dtype.itemsize]
    np.testing.assert_array_equal(j.view(uint), t.view(uint))


# ---------------------------------------------------------------------------
# tuned allreduce: every named algorithm, bitwise
# ---------------------------------------------------------------------------

ALLREDUCE_CASES = {
    "basic_linear": {},
    "nonoverlapping": {},
    "recursive_doubling": {},
    "ring": {},
    # pipelined ring: 4004 bytes per rank over 1024-byte segments -> 4
    "ring_pipelined": {"coll_pipeline_segsize": 1024},
    # segmented ring: 256-element segments -> 4 independent rings
    "segmented_ring": {"coll_tuned_segment_size": 1024},
}


@pytest.mark.parametrize("case", list(ALLREDUCE_CASES))
def test_tuned_allreduce_bitwise(tuned, case):
    jc, tc = tuned
    alg = case.replace("_pipelined", "")
    x = _inputs(N, COUNT)
    with accelerated_sum(), both(coll_tuned_allreduce_algorithm=alg,
                                 **ALLREDUCE_CASES[case]):
        jout = jc.allreduce(x)
        tout = tc.allreduce(x)
    _bits_equal(jout, tout)
    keys = [k for k in tc._coll_programs if k[2] == alg]
    assert any(any(getattr(e, "name", "") == "sum[cuda]" for e in k)
               for k in keys), keys
    if case == "ring_pipelined":
        assert any("pipelined" in k for k in keys), keys


@pytest.mark.parametrize("alg", ["recursive_doubling", "ring",
                                 "nonoverlapping", "basic_linear"])
def test_tuned_allreduce_bitwise_non_power_of_two(tuned6, alg):
    jc, tc = tuned6
    x = _inputs(6, COUNT, seed=11)
    with accelerated_sum(), both(coll_tuned_allreduce_algorithm=alg):
        _bits_equal(jc.allreduce(x), tc.allreduce(x))


def test_algorithms_differ_in_order(tuned):
    """The inputs are hard enough that two named orders disagree — so
    the bitwise checks above are not vacuous."""
    _, tc = tuned
    x = _inputs(N, COUNT)
    outs = {}
    for alg in ("basic_linear", "ring"):
        with both(coll_tuned_allreduce_algorithm=alg):
            outs[alg] = tc.allreduce(x).numpy()
    assert not np.array_equal(outs["basic_linear"].view(np.uint32),
                              outs["ring"].view(np.uint32))


def test_fixed_rules_pick_by_size(tuned):
    """No forcing: small buffers take recursive doubling, mid-size the
    ring, and both packages agree bitwise."""
    jc, tc = tuned
    with accelerated_sum():
        for count in (16, 4096):
            x = _inputs(N, count, seed=count)
            _bits_equal(jc.allreduce(x), tc.allreduce(x))
    algs = {k[2] for k in tc._coll_programs if k[:2] == ("tuned",
                                                         "allreduce")}
    assert {"recursive_doubling", "ring"} <= algs


# ---------------------------------------------------------------------------
# other tuned collectives, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alg,extra", [
    ("binomial", {}),
    ("binomial", {"coll_pipeline_segsize": 1024}),  # segmented binomial
    ("in_order_binary", {}),
    ("linear", {}),
])
@pytest.mark.parametrize("root", [0, 3])
def test_tuned_reduce_bitwise(tuned, alg, extra, root):
    jc, tc = tuned
    x = _inputs(N, COUNT, seed=root + 1)
    with accelerated_sum(), both(coll_tuned_reduce_algorithm=alg, **extra):
        _bits_equal(jc.reduce(x, root=root), tc.reduce(x, root=root))


@pytest.mark.parametrize("alg,extra", [
    ("binomial", {}),
    ("binomial", {"coll_pipeline_segsize": 1024}),
    ("binary_tree", {}),
    ("chain", {}),
    ("pipeline", {"coll_tuned_bcast_segment_size": 1024}),
    ("masked_psum", {}),
])
def test_tuned_bcast_bitwise(tuned, alg, extra):
    jc, tc = tuned
    x = _inputs(N, COUNT, seed=5)
    with both(coll_tuned_bcast_algorithm=alg, **extra):
        _bits_equal(jc.bcast(x, root=2), tc.bcast(x, root=2))


@pytest.mark.parametrize("alg", ["ring", "bruck", "recursive_doubling",
                                 "lax"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tuned_allgather_bitwise(tuned, alg, dtype):
    jc, tc = tuned
    x = _inputs(N, 2 * 37, seed=9).reshape(N, 37, 2)
    if dtype == "bfloat16":
        import ml_dtypes

        x = x.astype(ml_dtypes.bfloat16)
    with both(coll_tuned_allgather_algorithm=alg):
        _bits_equal(jc.allgather(x), tc.allgather(x))


def test_tuned_allgather_bruck_non_power_of_two(tuned6):
    jc, tc = tuned6
    x = _inputs(6, 50, seed=3)
    with both(coll_tuned_allgather_algorithm="bruck"):
        _bits_equal(jc.allgather(x), tc.allgather(x))


@pytest.mark.parametrize("comm", ["tuned", "tuned6"])
def test_tuned_reduce_scatter_block_bitwise(request, comm):
    jc, tc = request.getfixturevalue(comm)
    x = _inputs(jc.size, jc.size * 300, seed=21)
    with accelerated_sum():
        jout = jc.reduce_scatter_block(x)
        tout = tc.reduce_scatter_block(x)
    _bits_equal(jout, tout)
    assert any(getattr(k[2], "name", "") == "sum[cuda]"
               for k in tc._coll_programs
               if k[1] == "reduce_scatter_block")


@pytest.mark.parametrize("alg", ["pairwise", "bruck", "basic_linear",
                                 "lax"])
def test_tuned_alltoall_bitwise(tuned, alg):
    jc, tc = tuned
    x = np.random.default_rng(4).integers(
        -2**31, 2**31 - 1, size=(N, N * 33), dtype=np.int32)
    with both(coll_tuned_alltoall_algorithm=alg):
        _bits_equal(jc.alltoall(x), tc.alltoall(x))


def test_tuned_barrier_and_pvars(tuned):
    _, tc = tuned
    inv = tpvar.PVARS.lookup("coll_invocations")
    before = inv.read()
    tc.barrier()
    x = _inputs(N, 64)
    tc.allreduce(x)
    tc.allreduce(x)
    assert inv.read() == before + 2
    hits = tpvar.PVARS.lookup("coll_plan_cache_hits").read()
    assert hits["count"] >= 2 and hits["sum"] >= 1


# ---------------------------------------------------------------------------
# fused (xla-role) component on the default comm
# ---------------------------------------------------------------------------

def _np_fold(x):
    """numpy float32 simulation of spmd.fold_ranks' pairwise order."""
    g = list(x)
    while len(g) > 1:
        merged = [(g[i] + g[i + 1]).astype(np.float32)
                  for i in range(0, len(g) - 1, 2)]
        if len(g) % 2:
            merged.append(g[-1])
        g = merged
    return g[0]


def test_fused_owns_default_comm(worlds):
    _, tworld = worlds
    assert tworld._coll_providers["allreduce"][0] == "fused"


@pytest.mark.parametrize("count", [33, 4096])
def test_fused_allreduce_declared_order_and_psum(worlds, count):
    jworld, tworld = worlds
    rng = np.random.default_rng(count)
    x = rng.uniform(1.0, 2.0, size=(N, count)).astype(np.float32)
    with accelerated_sum():
        tout = tworld.allreduce(x).numpy()
    want = np.broadcast_to(_np_fold(x), tout.shape)
    np.testing.assert_array_equal(tout.view(np.uint32),
                                  np.ascontiguousarray(want).view(np.uint32))
    np.testing.assert_allclose(tout, np.asarray(jworld.allreduce(x)),
                               rtol=1e-6, atol=0)


def test_fused_prod_matches_xla_tree_bitwise(worlds):
    """For ops without a fused XLA collective the reference folds in
    the same pairwise tree order, so the two agree bit for bit."""
    jworld, tworld = worlds
    x = np.random.default_rng(2).uniform(0.5, 1.5, (N, 77)).astype(
        np.float32)
    _bits_equal(jworld.allreduce(x, jops.PROD),
                tworld.allreduce(x, tops.PROD))


@pytest.mark.parametrize("family", ["reduce", "bcast", "allgather",
                                    "reduce_scatter_block", "alltoall"])
def test_fused_collectives_match_xla(worlds, family):
    jworld, tworld = worlds
    x = np.random.default_rng(8).integers(-50, 50, (N, N * 6)).astype(
        np.float32)  # integer-valued: exact in any summation order
    kw = {"root": 5} if family in ("reduce", "bcast") else {}
    _bits_equal(getattr(jworld, family)(x, **kw),
                getattr(tworld, family)(x, **kw))


def test_fused_maxloc_pair_op(worlds):
    jworld, tworld = worlds
    rng = np.random.default_rng(6)
    vals = rng.integers(0, 5, (N, 40)).astype(np.float32)
    idxs = np.tile(np.arange(N, dtype=np.int32)[:, None], (1, 40))
    jv, ji = jworld.allreduce((vals, idxs), jops.MAXLOC)
    tv, ti = tworld.allreduce((vals, idxs), tops.MAXLOC)
    _bits_equal(jv, tv)
    _bits_equal(ji, ti)


# ---------------------------------------------------------------------------
# driver contract
# ---------------------------------------------------------------------------

def test_leading_axis_mismatch_is_err_count(worlds, tuned):
    from ompi_release_tpu.utils.errors import MPIError as JMPIError

    jworld, tworld = worlds
    bad = np.ones((N - 1, 16), np.float32)
    for tcomm, jcomm in ((tworld, jworld), (tuned[1], tuned[0])):
        with pytest.raises(MPIError) as te:
            tcomm.allreduce(bad)
        assert te.value.code == ErrorCode.ERR_COUNT
        with pytest.raises(JMPIError) as je:
            jcomm.allreduce(bad)
        assert int(je.value.code) == int(te.value.code)


def test_pair_tuple_with_plain_op_is_err_type(worlds):
    _, tworld = worlds
    x = np.ones((N, 4), np.float32)
    with pytest.raises(MPIError) as e:
        tworld.allreduce((x, x))
    assert e.value.code == ErrorCode.ERR_TYPE


def test_inputs_are_not_modified(tuned):
    _, tc = tuned
    x = torch.from_numpy(_inputs(N, COUNT))
    keep = x.clone()
    for alg in ("ring", "segmented_ring", "recursive_doubling"):
        with both(coll_tuned_allreduce_algorithm=alg,
                  coll_tuned_segment_size=1024):
            tc.allreduce(x)
    assert torch.equal(x, keep)


def test_self_comm_and_split_types(worlds):
    _, tworld = worlds
    self_comm = trt.Runtime.current().self_comm
    assert self_comm._coll_providers["allreduce"][0] == "self"
    x = torch.arange(6.0).reshape(1, 6)
    assert torch.equal(self_comm.allreduce(x), x)
    parts = tworld.split([r % 2 for r in range(N)], keys=list(range(N))[::-1])
    assert parts[0] is parts[2] and parts[0] is not parts[1]
    assert parts[0].group.world_ranks == (6, 4, 2, 0)
    for c in {id(p): p for p in parts}.values():
        c.free()
