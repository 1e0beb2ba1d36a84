"""Nonblocking & persistent collectives of the PyTorch port
(``coll/nbc.py``) held against the JAX package.

The in-process cases of ``tests/test_nbc.py`` (lines 63-285) on both
packages with the same numpy inputs: every i-family call completes with
the blocking call's result BITWISE (the nonblocking path runs the very
body the blocking path runs) and with the JAX package's i-family result
(both sides select ``coll=tuned``, whose named algorithms fold in the
same order: bitwise); non-commutative ops keep their fold order;
persistent ``*_init`` requests are inactive until started, fire twice
with the bound buffer changed in place between starts (as a numpy array
and as a tensor on the comm's device), and ``start()`` on an active
request raises. On the CPU a request is complete at dispatch; that the
dispatch returns before the device finishes is a card property, held by
``chip_smoke.py``.
"""

import os
import subprocess
import sys

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
from ompi_release_tpu_torch.request.request import Request
from ompi_release_tpu_torch.runtime import runtime as trt
from ompi_release_tpu_torch.utils.errors import ErrorCode, MPIError

N = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def worlds():
    jworld = jmpi.init()
    trt._reset_for_tests()
    tworld = tmpi.init(cli_args=["--mca", "runtime_virtual_ranks", str(N)],
                       device="cpu")
    yield jworld, tworld
    trt._reset_for_tests()
    tvar.VARS.unset("runtime_virtual_ranks")


@pytest.fixture(scope="module")
def comms(worlds):
    """A tuned communicator on each side."""
    jworld, tworld = worlds
    jvar.set_value("coll", "tuned")
    tvar.set_value("coll", "tuned")
    try:
        jc = jworld.dup(name="nbc_tuned")
        tc = tworld.dup(name="nbc_tuned")
    finally:
        jvar.VARS.unset("coll")
        tvar.VARS.unset("coll")
    yield jc, tc
    jc.free()
    tc.free()


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


def _same(got, want, what):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for a, b in zip(got, want):
            _same(a, b, what)
        return
    g, w = _np(got), _np(want)
    assert g.dtype == w.dtype, (what, g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=what)


def _cases(n, dtype):
    rng = np.random.RandomState(11)
    if dtype == np.float32:
        x = rng.randn(n, 8).astype(dtype)
    else:
        x = rng.randint(-1000, 1000, (n, 8)).astype(dtype)
    xrs = np.arange(n * 2 * n, dtype=dtype).reshape(n, 2 * n)
    xa2a = np.arange(n * n, dtype=dtype).reshape(n, n)
    counts = np.random.RandomState(3).randint(0, 4, (n, n))
    bufs = [np.arange(int(counts[i].sum()), dtype=dtype) + 100 * i
            for i in range(n)]
    ragged = [np.arange(i + 1, dtype=dtype) * (i + 1) for i in range(n)]
    # (method, args, blocking twin)
    return [
        ("iallreduce", (x, "SUM"), "allreduce"),
        ("iallreduce", (x, "MAX"), "allreduce"),
        ("ireduce", (x, "SUM", 3), "reduce"),
        ("ibcast", (x, 2), "bcast"),
        ("iallgather", (x,), "allgather"),
        ("igather", (x, 5), "gather"),
        ("iscatter", (xrs, 1), "scatter"),
        ("ireduce_scatter_block", (xrs, "SUM"), "reduce_scatter_block"),
        ("ireduce_scatter", (xrs, [2] * n), "reduce_scatter"),
        ("ialltoall", (xa2a,), "alltoall"),
        ("iscan", (x, "SUM"), "scan"),
        ("iexscan", (x, "SUM"), "exscan"),
        ("ialltoallv", (bufs, counts), "alltoallv"),
        ("iallgatherv", (ragged,), "allgatherv"),
    ]


def _bind(args, ops_mod):
    return tuple(getattr(ops_mod, a) if isinstance(a, str) else a
                 for a in args)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_icoll_parity_matrix(comms, dtype):
    """Every i-family call on the port: bitwise its blocking twin and the
    JAX package's i-family result (tuned on both sides)."""
    jc, tc = comms
    for name, args, blocking in _cases(N, dtype):
        targs, jargs = _bind(args, tops), _bind(args, jops)
        want = getattr(tc, blocking)(*targs)
        req = getattr(tc, name)(*targs)
        assert isinstance(req, Request)
        req.wait()
        assert req.test()[0], name
        _same(req.value, want, f"{name} {dtype.__name__} vs blocking")
        jreq = getattr(jc, name)(*jargs)
        jreq.wait()
        _same(req.value, jreq.value, f"{name} {dtype.__name__} vs JAX")
    rb = tc.ibarrier()
    rb.wait()
    assert rb.test()[0]


def test_icoll_noncommutative_exact(comms):
    """A non-commutative op keeps the exact fold order through the
    nonblocking path: bitwise the blocking call and JAX's."""
    jc, tc = comms
    tsub = tops.user_op("nbc_sub", lambda a, b: a - b, commute=False)
    jsub = jops.user_op("nbc_sub", lambda a, b: a - b, commute=False)
    x = (np.arange(N * 6, dtype=np.float32).reshape(N, 6) + 1.0) * 0.37
    want = tc.allreduce(x, tsub)
    req = tc.iallreduce(x, tsub)
    req.wait()
    _same(req.value, want, "noncommutative vs blocking")
    _same(req.value, jc.allreduce(x, jsub), "noncommutative vs JAX")
    req = tc.iscan(x, tsub)
    req.wait()
    _same(req.value, jc.scan(x, jsub), "noncommutative scan vs JAX")


def test_icollectives_complete_with_values(worlds):
    """The default (fused) providers too: every i-variant completes with
    the blocking result."""
    _, tw = worlds
    x = np.arange(N * 8, dtype=np.float32).reshape(N, 8)
    reqs = {
        "iallreduce": (tw.iallreduce(x, tops.SUM), tw.allreduce(x)),
        "ibcast": (tw.ibcast(x, root=2), tw.bcast(x, root=2)),
        "iallgather": (tw.iallgather(x), tw.allgather(x)),
        "ialltoall": (tw.ialltoall(x), tw.alltoall(x)),
    }
    for name, (req, want) in reqs.items():
        req.wait()
        assert req.test()[0], name
        _same(req.value, want, name)
    np.testing.assert_allclose(reqs["iallreduce"][0].value[3].numpy(),
                               x.sum(0))
    np.testing.assert_array_equal(reqs["ibcast"][0].value[5].numpy(), x[2])


@pytest.mark.parametrize("bound", ["numpy", "tensor"])
def test_persistent_families_fire_twice(comms, bound):
    """Every persistent family: inactive until start (tests complete and
    empty), fires, and a SECOND start reads the bound buffer's new bytes
    after an in-place change. ``tensor``: the buffer already lies on the
    comm's device and the plan reads it in place. Each fire is bitwise the
    JAX package's persistent request."""
    jc, tc = comms
    n = N
    mk = (lambda a: a) if bound == "numpy" else torch.from_numpy
    x = np.arange(n * 8, dtype=np.int32).reshape(n, 8)
    xrs = np.arange(n * 2 * n, dtype=np.int32).reshape(n, 2 * n)
    xa2a = np.arange(n * n, dtype=np.int32).reshape(n, n)
    counts = [2] * n
    bufs = {k: mk(v.copy()) for k, v in (("x", x), ("xrs", xrs),
                                         ("xa2a", xa2a))}
    jbufs = {k: v.copy() for k, v in (("x", x), ("xrs", xrs),
                                      ("xa2a", xa2a))}
    cases = [
        ("allreduce_init", "x", (), "allreduce"),
        ("bcast_init", "x", (1,), "bcast"),
        ("allgather_init", "x", (), "allgather"),
        ("reduce_scatter_init", "xrs", (counts,), "reduce_scatter"),
        ("alltoall_init", "xa2a", (), "alltoall"),
    ]
    for init, key, extra, blocking in cases:
        req = getattr(tc, init)(bufs[key], *extra)
        jreq = getattr(jc, init)(jbufs[key], *extra)
        assert req.test() == (True, None)  # inactive
        for _ in range(2):
            want = getattr(tc, blocking)(bufs[key], *extra)
            req.start()
            jreq.start()
            req.wait()
            jreq.wait()
            _same(req.value, want, f"{init} vs blocking")
            _same(req.value, jreq.value, f"{init} vs JAX")
            bufs[key] += 1  # in place: start() must see the new bytes
            jbufs[key] += 1
    br = tc.barrier_init()
    for _ in range(2):
        br.start()
        br.wait()
        assert br.test()[0]


def test_persistent_start_on_active_raises(worlds):
    _, tw = worlds
    with pytest.raises(MPIError):
        Request().start()  # non-persistent
    req = tw.barrier_init()
    req.start()
    # MPI_Start on an active persistent request is erroneous
    with pytest.raises(MPIError, match="active"):
        req.start()
    req.wait()
    req.start()  # complete -> restartable
    req.wait()
    starts = tpvar.PVARS.lookup("nbc_persistent_starts").read()
    assert starts >= 2


def test_dispatch_never_synchronises(worlds, monkeypatch):
    """Nothing on the i-family, ibarrier or start() dispatch path waits
    on a device (the port's counterpart of test_nbc.py's
    block_until_ready spy)."""
    _, tw = worlds

    def sync(*a, **k):
        raise AssertionError("dispatch synchronised")

    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    x = np.ones((N, 16), np.float32)
    reqs = [tw.ibarrier(), tw.iallreduce(x), tw.ialltoall(x)]
    p = tw.allreduce_init(x)
    p.start()
    monkeypatch.undo()
    for r in reqs + [p]:
        r.wait()


def test_submit_runs_in_posting_order_and_free_drains(worlds):
    """``_submit_serialized`` posts to the comm's schedule queue; free()
    runs what is still queued (a late completion, not a lost one)."""
    _, tw = worlds
    c = tw.dup(name="nbc_submit")
    order = []
    r1 = c._submit_serialized(lambda: order.append(1) or "one")
    r2 = c._submit_serialized(lambda: order.append(2) or "two")
    assert order == []
    r2.wait()
    assert order == [1, 2] and r1.is_complete and r2.value == "two"
    c._submit_serialized(lambda: order.append(3))
    assert c._run_serialized(lambda a: a * 2, 21) == 42
    c.free()
    assert order == [1, 2, 3]


def test_spanning_comm_is_not_available(worlds):
    """The multi-process branches are not ported: a comm that spans
    controller processes raises ERR_NOT_AVAILABLE, never runs
    in-process."""
    from ompi_release_tpu_torch.coll import nbc

    _, tw = worlds
    c = tw.dup(name="nbc_span")
    c.spans_processes = True
    for call in (lambda: nbc.icoll(c, "allreduce", (None, tops.SUM)),
                 lambda: nbc.persistent(c, "allreduce", (None, tops.SUM)),
                 lambda: nbc.submit(c, "f", lambda: 0, ()),
                 lambda: nbc.ibarrier(c)):
        with pytest.raises(MPIError) as ei:
            call()
        assert ei.value.code == ErrorCode.ERR_NOT_AVAILABLE
    c.free()


def test_slice_modules_load_no_jax():
    """The modules this slice adds import neither JAX nor the JAX
    package."""
    code = (
        "import sys\n"
        "import ompi_release_tpu_torch.runtime.progress\n"
        "import ompi_release_tpu_torch.coll.plan\n"
        "import ompi_release_tpu_torch.coll.nbc\n"
        "import ompi_release_tpu_torch.topo.topo\n"
        "import ompi_release_tpu_torch.comm.intercomm\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib',\n"
        "                                    'ompi_release_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
