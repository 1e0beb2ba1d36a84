"""OpenSHMEM of the PyTorch port (``oshmem/shmem.py``) held against the
JAX package.

The shmem classes of ``tests/test_shmem_topo.py`` (``TestShmem``,
``TestShmemLocks``, ``TestShmemExtendedApi``) run as one script on both
packages, 8 PEs on the CPU, with the same seeded numpy inputs; every
value is held BITWISE (the SHMEM ops are f32/int32 adds, replaces and
compares in the same order, and the scoll reductions run the same tuned
algorithms, which the collectives' own tests hold bitwise), both with
the bulk path (``shmem_bulk``, the default) and without it. Added here:
the bulk path's one drain per allocation, ``local()`` as a snapshot, and
the lock contention run with more contenders than the JAX test's.
"""

import functools
import threading
import time

import numpy as np
import pytest
import torch

import ompi_release_tpu as jmpi
from ompi_release_tpu.mca import pvar as jpvar
from ompi_release_tpu.mca import var as jvar
from ompi_release_tpu.oshmem import shmem as jshmem
from ompi_release_tpu.utils.errors import MPIError as JMPIError
import ompi_release_tpu_torch as tmpi
from ompi_release_tpu_torch.mca import pvar as tpvar
from ompi_release_tpu_torch.mca import var as tvar
from ompi_release_tpu_torch.oshmem import shmem as tshmem
from ompi_release_tpu_torch.runtime import runtime as trt
from ompi_release_tpu_torch.utils.errors import MPIError as TMPIError

N = 8


@pytest.fixture(scope="module")
def worlds():
    """Tuned duplicates of both WORLDs: the scoll reductions then run the
    same named algorithms, bitwise (the default WORLD's JAX ``xla``
    component leaves the psum order to XLA; the port's fused fold is
    held to it within rtol 1e-6 in ``tests/test_torch_coll.py``)."""
    jworld = jmpi.init()
    trt._reset_for_tests()
    tworld = tmpi.init(cli_args=["--mca", "runtime_virtual_ranks", str(N)],
                       device="cpu")
    for var in (jvar, tvar):
        var.set_value("coll", "tuned")
    try:
        comms = (jworld.dup(name="shmem_tuned"),
                 tworld.dup(name="shmem_tuned"))
    finally:
        for var in (jvar, tvar):
            var.VARS.unset("coll")
    yield comms
    for c in comms:
        c.free()
    trt._reset_for_tests()
    tvar.VARS.unset("runtime_virtual_ranks")


class Side:
    def __init__(self, name, world):
        jax = name == "jax"
        self.world = world
        self.shmem = jshmem if jax else tshmem
        self.pvar = jpvar if jax else tpvar
        self.var = jvar if jax else tvar
        self.Error = JMPIError if jax else TMPIError

    def pv(self, name):
        return self.pvar.PVARS.lookup(name).read()


def obs(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if hasattr(v, "dtype") and hasattr(v, "shape"):
        return np.asarray(v)
    if isinstance(v, (list, tuple)):
        return [obs(x) for x in v]
    return v


def same(a, b):
    a, b = obs(a), obs(b)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def both(worlds, script, bulk=True):
    out = []
    for name, world in zip(("jax", "torch"), worlds):
        S = Side(name, world)
        S.var.set_value("shmem_bulk", bulk)
        ctx = S.shmem.ShmemCtx(world)
        try:
            out.append(script(S, ctx))
        finally:
            ctx.finalize()
            S.var.VARS.unset("shmem_bulk")
    j, t = out
    assert same(j, t), (obs(j), obs(t))
    return j, t


def raises(S, fn):
    try:
        fn()
    except S.Error as e:
        return ("raised", e.code.name)
    return None


# ---------------------------------------------------------------------------
# TestShmem
# ---------------------------------------------------------------------------

def sc_put_get_roundtrip(S, ctx):
    sym = ctx.malloc((4,), np.float32)
    x = np.random.default_rng(1).standard_normal(4).astype(np.float32)
    ctx.put(sym, x, pe=2)
    ctx.quiet()
    out = [ctx.get(sym, pe=2), ctx.get(sym, pe=1)]
    sym.free()
    return out


def sc_atomic_add_and_fetch(S, ctx):
    sym = ctx.malloc((2,), np.float32)
    x = np.random.default_rng(2).standard_normal((4, 2)).astype(np.float32)
    for row in x[:3]:
        ctx.atomic_add(sym, row, pe=0)
    old = ctx.atomic_fetch_add(sym, x[3], pe=0)
    out = [old, ctx.get(sym, pe=0)]
    sym.free()
    return out


def sc_atomic_swap_cswap(S, ctx):
    sym = ctx.malloc((1,), np.int32)
    out = [ctx.atomic_swap(sym, np.array([5], np.int32), pe=3)]
    out.append(ctx.atomic_compare_swap(sym, cond=np.array([5], np.int32),
                                       value=np.array([9], np.int32), pe=3))
    out.append(ctx.get(sym, pe=3))
    out.append(ctx.atomic_compare_swap(sym, cond=np.array([5], np.int32),
                                       value=np.array([1], np.int32), pe=3))
    out.append(ctx.get(sym, pe=3))
    sym.free()
    return out


def sc_barrier_all_flushes_puts(S, ctx):
    sym = ctx.malloc((3,), np.float32)
    for pe in range(ctx.n_pes):
        ctx.put(sym, np.full(3, float(pe), np.float32), pe=pe)
    ctx.barrier_all()
    out = [sym.local(pe) for pe in range(ctx.n_pes)]
    sym.free()
    return out


def sc_put_elem_and_fence(S, ctx):
    sym = ctx.malloc((5,), np.float32)
    for i in range(5):
        ctx.put_elem(sym, np.float32(i * 1.5), i, pe=4)
    ctx.fence()
    ctx.put_elem(sym, np.float32(-1.0), 2, pe=4)
    out = [ctx.get(sym, pe=4)]
    sym.free()
    return out


def sc_scoll_delegates(S, ctx):
    x = np.random.RandomState(0).randn(N, 8).astype(np.float32)
    return [ctx.sum_to_all(x), ctx.fcollect(x[:, :2]),
            ctx.broadcast(x, root=3), ctx.alltoall(x),
            ctx.max_to_all(x), ctx.min_to_all(x)]


# ---------------------------------------------------------------------------
# TestShmemLocks
# ---------------------------------------------------------------------------

def sc_lock_acquire_release_cycle(S, ctx):
    lk = ctx.lock_create()
    ctx.set_lock(lk, pe=1)
    out = [ctx.test_lock(lk, pe=2)]  # held: attempt fails
    ctx.clear_lock(lk, pe=1)
    out.append(ctx.test_lock(lk, pe=2))  # free: attempt acquires
    ctx.clear_lock(lk, pe=2)
    return out


def sc_lock_wrong_holder(S, ctx):
    lk = ctx.lock_create()
    ctx.set_lock(lk, pe=0)
    out = [raises(S, lambda: ctx.clear_lock(lk, pe=3)),
           raises(S, lambda: ctx.set_lock(lk, pe=0))]  # non-recursive
    ctx.clear_lock(lk, pe=0)
    out.append(raises(S, lambda: ctx.clear_lock(lk, pe=0)))  # already free
    return out


# ---------------------------------------------------------------------------
# TestShmemExtendedApi
# ---------------------------------------------------------------------------

def sc_inc_set_fetch(S, ctx):
    s = ctx.malloc((2,), np.float32)
    ctx.atomic_set(s, np.array([5.0, 7.0], np.float32), pe=1)
    ctx.atomic_inc(s, pe=1)
    out = [ctx.atomic_fetch(s, pe=1), ctx.atomic_fetch_inc(s, pe=1),
           ctx.get(s, pe=1)]
    s.free()
    return out


def sc_wait_until_and_test(S, ctx):
    flag = ctx.malloc((1,), np.float32)
    out = [ctx.test(flag, "ge", 1.0, pe=2)]

    def producer():
        time.sleep(0.2)
        ctx.atomic_add(flag, np.ones(1, np.float32), pe=2)
        ctx.quiet()

    t = threading.Thread(target=producer)
    t.start()
    got = ctx.wait_until(flag, "ge", 1.0, pe=2, timeout_s=10)
    t.join(timeout=30)
    out += [not t.is_alive(), got, ctx.test(flag, "ge", 1.0, pe=2),
            raises(S, lambda: ctx.wait_until(flag, "lt", 0.0, pe=2,
                                             timeout_s=0.2)),
            raises(S, lambda: ctx.wait_until(flag, "approximately", 1.0,
                                             pe=2))]
    return out


def sc_collect_and_reductions(S, ctx):
    ragged = [np.arange(i + 1, dtype=np.float32) for i in range(N)]
    x = np.full((N, 4), 2.0, np.float32)
    xi = np.arange(N * 2, dtype=np.int32).reshape(N, 2)
    return [ctx.collect(ragged), ctx.prod_to_all(x), ctx.xor_to_all(xi),
            ctx.or_to_all(xi), ctx.and_to_all(xi)]


CASES = [sc_put_get_roundtrip, sc_atomic_add_and_fetch,
         sc_atomic_swap_cswap, sc_barrier_all_flushes_puts,
         sc_put_elem_and_fence, sc_scoll_delegates,
         sc_lock_acquire_release_cycle, sc_lock_wrong_holder,
         sc_inc_set_fetch, sc_wait_until_and_test,
         sc_collect_and_reductions]


@pytest.mark.parametrize("bulk", [True, False], ids=["bulk", "per_call"])
@pytest.mark.parametrize("script", CASES, ids=lambda f: f.__name__[3:])
def test_shmem_case_matches_jax(worlds, script, bulk):
    both(worlds, script, bulk=bulk)


def test_closed_forms(worlds):
    """The JAX test's own closed forms, on the port's results (the sum
    within the JAX test's rtol 2e-5: the closed form folds in another
    order)."""
    _, t = both(worlds, sc_scoll_delegates)
    x = np.random.RandomState(0).randn(N, 8).astype(np.float32)
    np.testing.assert_allclose(obs(t[0])[0], x.sum(0), rtol=2e-5, atol=1e-5)
    assert obs(t[1]).shape == (N, N * 2)
    _, t = both(worlds, sc_put_get_roundtrip)
    np.testing.assert_array_equal(obs(t[1]), np.zeros(4))
    _, t = both(worlds, sc_atomic_swap_cswap)
    assert [int(obs(v)[0]) for v in t] == [0, 5, 9, 9, 9]
    _, t = both(worlds, sc_inc_set_fetch)
    np.testing.assert_array_equal(obs(t[2]), [7.0, 9.0])
    _, t = both(worlds, sc_collect_and_reductions)
    np.testing.assert_array_equal(obs(t[0]),
                                  np.concatenate([np.arange(i + 1)
                                                  for i in range(N)]))
    np.testing.assert_array_equal(obs(t[1])[0], np.full(4, 2.0 ** N))
    xi = np.arange(N * 2, dtype=np.int32).reshape(N, 2)
    np.testing.assert_array_equal(obs(t[2])[0],
                                  functools.reduce(np.bitwise_xor, xi))


def test_bulk_path_drains_once_per_allocation(worlds):
    """Posted ops batch per allocation and drain as one epoch: the same
    pvar deltas on both packages, and one frozen plan replayed."""
    def script(S, ctx):
        a = ctx.malloc((4,), np.float32)
        b = ctx.malloc((2,), np.int32)
        o0, f0 = S.pv("shmem_bulk_ops"), S.pv("shmem_bulk_flushes")
        for rnd in range(3):
            for pe in range(N):
                ctx.put(a, np.full(4, pe + rnd, np.float32), pe=pe)
                ctx.atomic_add(b, np.array([pe, 1], np.int32), pe=pe)
            ctx.quiet()
        out = [S.pv("shmem_bulk_ops") - o0,
               S.pv("shmem_bulk_flushes") - f0,
               len(a._win._access_plans), len(b._win._access_plans),
               [a.local(pe) for pe in range(N)],
               [b.local(pe) for pe in range(N)]]
        a.free()
        b.free()
        return out

    j, _ = both(worlds, script)
    assert j[:4] == [48, 6, 1, 1]


def test_local_is_a_snapshot(worlds):
    ctx = tshmem.ShmemCtx(worlds[1])
    try:
        s = ctx.malloc((3,), np.float32)
        ctx.put(s, np.ones(3, np.float32), pe=5)
        held = s.local(5)
        ctx.atomic_add(s, np.ones(3, np.float32), pe=5)
        ctx.quiet()
        assert held.tolist() == [1.0] * 3
        assert s.local(5).tolist() == [2.0] * 3
    finally:
        ctx.finalize()


@pytest.mark.parametrize("n_pes,iters", [(4, 25), (8, 12)])
def test_lock_contention_mutual_exclusion(worlds, n_pes, iters):
    """Contending PEs (threads) do lost-update-prone read-modify-writes
    on a shared word under the lock: the final count proves mutual
    exclusion (TestShmemLocks::test_contention_mutual_exclusion, with a
    shortened switch interval)."""
    import sys

    ctx = tshmem.ShmemCtx(worlds[1])
    lk = ctx.lock_create()
    counter = ctx.malloc((1,), np.int32)
    errs = []

    def contender(pe):
        try:
            for _ in range(iters):
                ctx.set_lock(lk, pe=pe)
                try:
                    v = int(ctx.atomic_fetch(counter, pe=0).reshape(-1)[0])
                    ctx.atomic_set(counter, v + 1, pe=0)
                finally:
                    ctx.clear_lock(lk, pe=pe)
        except Exception as e:  # surfaced after join
            errs.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=contender, args=(pe,))
                   for pe in range(n_pes)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    final = int(ctx.atomic_fetch(counter, pe=0).reshape(-1)[0])
    ctx.finalize()
    assert final == n_pes * iters, final


def test_shmem_init_finalize(worlds):
    ctx = tshmem.shmem_init(worlds[1])
    try:
        assert tshmem.shmem_init() is ctx and ctx.n_pes == N
        ctx.malloc((2,), np.float32)
    finally:
        tshmem.shmem_finalize()
    assert tshmem._ctx is None and not ctx._allocs
