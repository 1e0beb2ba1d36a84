"""One-sided windows of the PyTorch port (``osc/window.py``) held against
the JAX package.

Every case of ``tests/test_osc.py`` (fence, passive-target and PSCW
epochs, single-element RMA, the bounded program cache, window creation,
shared windows, the predefined attributes, dynamic windows) runs as one
script on both packages, WORLD of 8 ranks on the CPU, with the same
numpy inputs from a seeded generator; what each script observes (values,
errors by class name, flags) must be equal, values BITWISE (the ops are
f32/int32 adds, max, replace and compare applied in the same order).
Added here: the snapshot rule (``read()``, a get's value and
``shared_query`` never change under a later epoch, as JAX's immutable
arrays do not), the call-time copy of a numpy payload, a float payload
truncating into an int32 window, and the spanning-comm refusal.
"""

import numpy as np
import pytest
import torch

import ompi_release_tpu as jmpi
from ompi_release_tpu import ops as jops
from ompi_release_tpu import osc as josc
from ompi_release_tpu.comm import communicator as jcomm
from ompi_release_tpu.osc import window as jwin
from ompi_release_tpu.utils.errors import MPIError as JMPIError
import ompi_release_tpu_torch as tmpi
from ompi_release_tpu_torch import ops as tops
from ompi_release_tpu_torch import osc as tosc
from ompi_release_tpu_torch.comm import communicator as tcomm
from ompi_release_tpu_torch.mca import var as tvar
from ompi_release_tpu_torch.osc import window as twin
from ompi_release_tpu_torch.runtime import runtime as trt
from ompi_release_tpu_torch.utils.errors import MPIError as TMPIError

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


class Side:
    """One package's surface, so one script drives both."""

    def __init__(self, name, world):
        self.name, self.world = name, world
        jax = name == "jax"
        self.osc = josc if jax else tosc
        self.W = jwin if jax else twin
        self.ops = jops if jax else tops
        self.comm_mod = jcomm if jax else tcomm
        self.Error = JMPIError if jax else TMPIError


def obs(v):
    """A comparable host value: arrays keep their dtype and bits (bf16 as
    its int16 bit pattern)."""
    if isinstance(v, torch.Tensor):
        if v.dtype is torch.bfloat16:
            v = v.view(torch.int16)
        return np.asarray(v.detach().cpu().numpy())
    if hasattr(v, "dtype") and hasattr(v, "shape"):
        a = np.asarray(v)
        return a.view(np.int16) if a.dtype.name == "bfloat16" else a
    return v


def same(a, b):
    a, b = obs(a), obs(b)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def raises(S, fn):
    """The class of the MPIError ``fn`` raises, or None."""
    try:
        fn()
    except S.Error as e:
        return ("raised", e.code.name)
    return None


def both(worlds, script):
    jw, tw = worlds
    j = script(Side("jax", jw))
    t = script(Side("torch", tw))
    assert len(j) == len(t)
    for k, (a, b) in enumerate(zip(j, t)):
        assert same(a, b), (k, obs(a), obs(b))
    return j, t


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# the cases of tests/test_osc.py, as scripts over both packages
# ---------------------------------------------------------------------------

def sc_put_get_fence(S):
    w = S.osc.win_allocate(S.world, (4,), np.float32)
    pay = _rng(1).standard_normal(4).astype(np.float32)
    w.fence()
    w.put(pay, target=3)
    g = w.get(target=3)
    done_early = g.is_complete
    w.fence()
    out = [done_early, g.value, w.read()]
    w.fence_end()
    w.free()
    return out


def sc_rma_outside_epoch(S):
    w = S.osc.win_allocate(S.world, (4,), np.float32)
    out = [raises(S, lambda: w.put(np.zeros(4, np.float32), target=0))]
    w.free()
    return out


def sc_ordering_put_then_get(S):
    w = S.osc.win_allocate(S.world, (4,), np.float32)
    a, b = _rng(2).standard_normal((2, 4)).astype(np.float32)
    w.fence()
    w.put(a, target=0)
    g1 = w.get(target=0)
    w.put(b, target=0)
    g2 = w.get(target=0)
    w.fence_end()
    w.free()
    return [g1.value, g2.value]


def sc_accumulate_sum_and_max(S):
    w = S.osc.win_allocate(S.world, (4,), np.float32)
    x = _rng(3).standard_normal((4, 4)).astype(np.float32)
    w.fence()
    for t, row in zip((1, 1, 2), x):
        w.accumulate(row, target=t, op=S.ops.SUM)
    w.accumulate(x[3], target=2, op=S.ops.MAX)
    w.fence_end()
    out = [w.read()]
    w.free()
    return out


def sc_lock_unlock(S):
    w = S.osc.win_allocate(S.world, (4,), np.float32)
    w.lock(2, S.osc.LOCK_EXCLUSIVE)
    w.put(np.full(4, 9.0, np.float32), target=2)
    w.unlock(2)
    w.lock(1)
    err = raises(S, lambda: w.put(np.zeros(4, np.float32), target=3))
    w.unlock(1)
    out = [w.read(), err]
    w.free()
    return out


def sc_lock_all_flush(S):
    w = S.osc.win_allocate(S.world, (4,), np.float32)
    x = _rng(4).standard_normal((2, 4)).astype(np.float32)
    w.lock_all()
    w.accumulate(x[0], target=0)
    w.flush(0)
    mid = w.read()
    w.accumulate(x[1], target=0)
    w.unlock_all()
    out = [mid, w.read()]
    w.free()
    return out


def sc_fetch_and_op_and_cas(S):
    w = S.osc.win_allocate(S.world, (4,), np.float32)
    w.lock(5)
    f = w.fetch_and_op(np.full(4, 3.0, np.float32), target=5, op=S.ops.SUM)
    w.unlock(5)
    w.lock(4)
    w.put(np.full(4, 1.0, np.float32), target=4)
    w.flush(4)
    c = w.compare_and_swap(np.array([8, 8, 2, 8], np.float32),
                           compare=np.array([1, 0, 1, 1], np.float32),
                           target=4)
    w.unlock(4)
    out = [f.value, c.value, w.read()]
    w.free()
    return out


def sc_single_element(S):
    """test_indexed_put, the two indexed CAS cases, indexed fetch-add and
    the mixed epoch, on one window."""
    w = S.osc.win_allocate(S.world, (4,), np.float32)
    w.fence()
    w.put(np.float32(5.0), target=2, index=1)
    w.fence_end()
    out = [w.read()]
    w.lock(3)
    w.put(np.full(4, 1.0, np.float32), target=3)
    w.flush(3)
    c1 = w.compare_and_swap(np.float32(9.0), compare=np.float32(1.0),
                            target=3, index=2)
    c2 = w.compare_and_swap(np.float32(7.0), compare=np.float32(5.0),
                            target=3, index=0)
    w.unlock(3)
    w.lock(0)
    f = w.fetch_and_op(np.float32(4.0), target=0, op=S.ops.SUM, index=3)
    w.unlock(0)
    w.fence()
    w.put(np.full(4, 1.0, np.float32), target=6)
    w.accumulate(np.float32(10.0), target=6, op=S.ops.SUM, index=0)
    g = w.get(target=6)
    w.fence_end()
    out += [c1.value, c2.value, f.value, g.value, w.read()]
    w.free()
    return out


def sc_scalar_payload_epoch(S):
    w = S.osc.win_allocate(S.world, (16,), np.float32)
    w.fence()
    for _ in range(5):
        w.accumulate(np.float32(2.0), target=1, op=S.ops.SUM)
    w.accumulate(np.float32(-1.5), target=1, op=S.ops.REPLACE)
    w.accumulate(np.float32(0.25), target=2, op=S.ops.SUM)
    w.fence_end()
    out = [w.read()]
    w.free()
    return out


def sc_pscw(S):
    """test_post_start_complete, test_complete_then_wait, MPI_Win_test,
    flush_local, sync, the PSCW errors and request-based RMA."""
    g = S.world.group
    w = S.osc.win_allocate(S.world, (4,), np.float32)
    out = [raises(S, w.wait), raises(S, w.test)]
    w.post(g)
    w.start(g)
    w.put(np.full(4, 6.0, np.float32), target=1)
    w.complete()
    w.wait()
    w.post(g)
    w.start(g)
    w.accumulate(np.float32(1.0), target=2)
    w.complete()
    out += [w.test(), raises(S, w.test)]
    w.lock(1)
    w.put(np.full(4, 3.25, np.float32), 1)
    w.flush_local(1)
    w.flush_local_all()
    w.unlock(1)
    w.sync()
    w.lock(3)
    r1 = w.rput(np.full(4, 2.0, np.float32), 3)
    r2 = w.raccumulate(np.full(4, 0.5, np.float32), 3)
    early = (r1.is_complete, r2.is_complete)
    w.flush(3)
    out += [early, (r1.is_complete, r2.is_complete)]
    r3 = w.rget(3)
    w.flush(3)
    r4 = w.rget_accumulate(np.full(4, 1.0, np.float32), 3, op=S.ops.SUM)
    r4.wait()  # per-op flush semantics: wait() alone completes it
    w.unlock(3)
    out += [r3.value, r4.value, w.read()]
    w.free()
    return out


def sc_keyvals(S):
    deleted = []
    kv = S.comm_mod.create_keyval(
        delete_fn=lambda w, k, v, es: deleted.append(v))
    w = S.osc.win_allocate(S.world, (4,), np.float32)
    try:
        out = [w.get_attr(kv)]
        w.set_attr(kv, {"tag": 42})
        out.append(w.get_attr(kv))
        w.delete_attr(kv)
        out += [list(deleted), w.get_attr(kv), w.get_attr("win_model")]
        w.set_attr(kv, "at-free")
        w.free()
        out.append(list(deleted))
    finally:
        S.comm_mod.free_keyval(kv)
    return out


def sc_create(S):
    base = _rng(5).standard_normal((N, 2)).astype(np.float32)
    w = S.osc.win_create(S.world, base)
    w.fence()
    g = w.get(target=N - 1)
    w.fence_end()
    out = [g.value, raises(S, lambda: S.osc.win_create(
        S.world, np.zeros((N + 1, 3), np.float32)))]
    w.free()
    w = S.osc.win_allocate(S.world, (2,), np.float32)
    w.fence()
    w.put(np.ones(2, np.float32), target=0)
    out.append(raises(S, w.free))
    w.fence_end()
    w.free()
    out.append(raises(S, w.fence))
    return out


def sc_shared_window(S):
    w = S.osc.win_allocate_shared(S.world, (6,), np.float32)
    w.lock_all()
    w.put(np.arange(6, dtype=np.float32), 3)
    w.flush_all()
    size, disp, blk = w.shared_query(3)
    _, _, blk0 = w.shared_query(-1)
    out = [size, disp, blk, tuple(blk0.shape),
           raises(S, lambda: w.shared_query(99))]
    w.unlock_all()
    w.free()
    plain = S.osc.win_allocate(S.world, (2,), np.float32)
    out.append(raises(S, lambda: plain.shared_query(0)))
    plain.free()
    return out


def sc_multi_host_rejected(S):
    import dataclasses

    rt = S.world.runtime
    old = rt.endpoints
    try:
        rt.endpoints = [
            dataclasses.replace(ep, host="hostB" if ep.rank >= 4
                                else "hostA")
            for ep in old
        ]
        out = [raises(S, lambda: S.osc.win_allocate_shared(
            S.world, (2,), np.float32))]
        sub = S.world.create(S.world.group.incl([0, 1, 2]), name="one_host")
        try:
            w = S.osc.win_allocate_shared(sub, (2,), np.float32)
            out.append(w.get_attr(S.W.WIN_CREATE_FLAVOR))
            w.free()
        finally:
            sub.free()
    finally:
        rt.endpoints = old
    return out


def sc_predefined_attributes(S):
    W = S.W
    out = []
    for ctor in (S.osc.win_allocate, W.win_allocate_shared):
        w = ctor(S.world, (6,), np.float32)
        found, base = w.get_attr(W.WIN_BASE)
        out += [w.get_attr(W.WIN_SIZE), w.get_attr(W.WIN_DISP_UNIT),
                w.get_attr(W.WIN_CREATE_FLAVOR), w.get_attr(W.WIN_MODEL),
                found, base, w.get_attr("nonsense")]
        w.free()
    w = W.win_create(S.world, np.zeros((N, 2), np.float32))
    out.append(w.get_attr(W.WIN_CREATE_FLAVOR))
    w.free()
    return out


def sc_dynamic_attach_rma_detach(S):
    W = S.W
    w = S.osc.win_create_dynamic(S.world)
    out = [w.get_attr(W.WIN_CREATE_FLAVOR), w.get_attr(W.WIN_SIZE)]
    r1 = w.attach((4,), np.float32)
    r2 = w.attach((2,), np.int32)
    w.fence()
    w.put(np.full(4, 3.0, np.float32), 1, region=r1)
    w.accumulate(np.array([5, 7], np.int32), 6, region=r2)
    g = w.get(1, region=r1)
    w.fence_end()
    out += [g.value, w.read(r2)]
    w.detach(r1)
    out.append(raises(S, lambda: w.put(np.zeros(4, np.float32), 0,
                                       region=r1)))
    w.lock_all()
    f = w.fetch_and_op(np.array([1, 1], np.int32), 6, region=r2,
                       op=S.ops.SUM)
    w.unlock_all()
    out += [f.value, w.read(r2)]
    w.free()
    out.append(raises(S, lambda: w.attach((2,), np.float32)))
    # detach with pending refused
    w = S.osc.win_create_dynamic(S.world)
    r = w.attach((2,), np.float32)
    w.fence()
    w.put(np.ones(2, np.float32), 0, region=r)
    out.append(raises(S, lambda: w.detach(r)))
    w.fence_end()
    w.detach(r)
    w.free()
    return out


def sc_dynamic_attach_mid_epoch(S):
    w = S.osc.win_create_dynamic(S.world)
    r1 = w.attach((2,), np.float32)
    w.fence()
    w.put(np.ones(2, np.float32), 0, region=r1)
    r2 = w.attach((3,), np.float32)  # joins the open epoch
    w.put(np.full(3, 4.0, np.float32), 5, region=r2)
    w.fence_end()
    out = [w.read(r2)]
    w.lock_all()
    r3 = w.attach((2,), np.float32)  # joins the lock epoch
    w.put(np.full(2, 9.0, np.float32), 1, region=r3)
    w.flush_all()
    out.append(w.read(r3))
    w.unlock_all()
    w.free()
    return out


def sc_dynamic_free_is_atomic(S):
    w = S.osc.win_create_dynamic(S.world)
    r1 = w.attach((2,), np.float32)
    r2 = w.attach((2,), np.float32)
    w.fence()
    w.put(np.ones(2, np.float32), 0, region=r2)
    out = [raises(S, w.free)]
    w.put(np.ones(2, np.float32), 0, region=r1)
    w.fence_end()
    out.append(w.read(r1))
    w.free()
    return out


def sc_int32_window_float_payload(S):
    """A float payload into an int32 window truncates toward zero (the
    payload is cast with ``astype`` in both packages)."""
    w = S.osc.win_allocate(S.world, (4,), np.int32)
    w.fence()
    w.put(np.array([2.7, -2.7, 0.5, -0.5], np.float32), target=1)
    w.accumulate(np.array([1.9, -1.9, 3.99, 7.0], np.float32), target=2)
    w.accumulate(np.float32(-3.6), target=2, op=S.ops.SUM, index=3)
    w.fence_end()
    out = [w.read()]
    w.free()
    return out


def sc_mixed_kinds_random(S):
    """A longer random epoch mixing every kind, indexed and not, over
    several targets, f32 and int32."""
    out = []
    for dtype in (np.float32, np.int32):
        rng = _rng(11)
        w = S.osc.win_allocate(S.world, (3, 5), dtype)
        reqs = []
        w.fence()
        for k in range(40):
            t = int(rng.integers(0, N))
            kind = k % 6
            idx = int(rng.integers(0, 15)) if rng.random() < 0.5 else None
            full = (rng.standard_normal((3, 5)) * 8).astype(dtype)
            one = dtype(full.reshape(-1)[0])
            pay = full if idx is None else one
            if kind == 0:
                w.put(pay, target=t, index=idx)
            elif kind == 1:
                w.accumulate(pay, target=t, op=S.ops.SUM, index=idx)
            elif kind == 2:
                reqs.append(w.get(target=t))
            elif kind == 3:
                reqs.append(w.get_accumulate(pay, target=t, op=S.ops.MAX,
                                             index=idx))
            elif kind == 4:
                reqs.append(w.compare_and_swap(
                    pay, np.zeros_like(pay) if idx is None else dtype(0),
                    target=t, index=idx))
            else:
                w.accumulate(pay, target=t, op=S.ops.MIN, index=idx)
        w.fence_end()
        out += [r.value for r in reqs] + [w.read()]
        w.free()
    return out


CASES = [sc_put_get_fence, sc_rma_outside_epoch, sc_ordering_put_then_get,
         sc_accumulate_sum_and_max, sc_lock_unlock, sc_lock_all_flush,
         sc_fetch_and_op_and_cas, sc_single_element,
         sc_scalar_payload_epoch, sc_pscw, sc_keyvals, sc_create,
         sc_shared_window, sc_multi_host_rejected,
         sc_predefined_attributes, sc_dynamic_attach_rma_detach,
         sc_dynamic_attach_mid_epoch, sc_dynamic_free_is_atomic,
         sc_int32_window_float_payload, sc_mixed_kinds_random]


@pytest.mark.parametrize("compiled", [True, False],
                         ids=["plans", "interpreted"])
@pytest.mark.parametrize("script", CASES, ids=lambda f: f.__name__[3:])
def test_osc_case_matches_jax(worlds, script, compiled):
    """Each case observes the same on both packages, bitwise; with
    ``osc_compiled`` off on the port every close runs interpreted."""
    if not compiled:
        tvar.set_value("osc_compiled", 0)
    try:
        j, t = both(worlds, script)
    finally:
        tvar.VARS.unset("osc_compiled")
    assert any(isinstance(v, np.ndarray) or hasattr(v, "shape")
               or v is not None for v in j)


def test_int32_truncation_closed_form(worlds):
    """The float-into-int32 case against its closed form (toward
    zero)."""
    _, t = both(worlds, sc_int32_window_float_payload)
    got = obs(t[0])
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got[1], [2, -2, 0, 0])
    np.testing.assert_array_equal(got[2], [1, -1, 3, 7 - 3])


def test_program_cache_bounded(worlds):
    """Epoch lengths 3..8 of one branch set land in at most two padded
    programs, on both packages alike."""
    added = []
    for S in (Side("jax", worlds[0]), Side("torch", worlds[1])):
        w = S.osc.win_allocate(S.world, (8,), np.float32)
        before = len(S.W._program_cache)
        for n_ops in (3, 4, 5, 6, 7, 8):
            w.fence()
            for k in range(n_ops):
                w.accumulate(np.float32(1.0), target=k % N, op=S.ops.SUM,
                             index=k % 8)
            w.fence_end()
        added.append(len(S.W._program_cache) - before)
        w.free()
    assert added[1] == added[0] and added[1] <= 2, added


# ---------------------------------------------------------------------------
# what the port adds: snapshots, call-time copies, spanning comms
# ---------------------------------------------------------------------------

def test_read_and_get_values_are_snapshots(worlds):
    """A value handed out before a later epoch does not change under it:
    read(), a get's value, shared_query's block and WIN_BASE (JAX's
    arrays are immutable; the port's storage is written in place)."""
    world = worlds[1]
    w = tosc.win_allocate_shared(world, (4,), np.float32)
    w.fence()
    w.put(np.full(4, 1.0, np.float32), target=2)
    g = w.get(target=2)
    w.fence_end()
    snap, base = w.read(), w.get_attr(twin.WIN_BASE)[1]
    _, _, blk = w.shared_query(2)
    held = [g.value.clone(), snap.clone(), base.clone(), blk.clone()]
    for _ in range(2):  # an interpreted close, then a plan's replay
        w.fence()
        w.accumulate(np.full(4, 5.0, np.float32), target=2)
        w.fence_end()
    assert float(w.read()[2, 0]) == 11.0
    for v, h in zip((g.value, snap, base, blk), held):
        assert torch.equal(v, h)
    w.free()


def test_numpy_payload_copied_at_call_time(worlds):
    """A caller that reuses its numpy buffer before the close gets the
    value it passed, as with ``jnp.asarray``, on both packages."""
    def script(S):
        w = S.osc.win_allocate(S.world, (4,), np.float32)
        buf = np.full(4, 2.0, np.float32)
        out = []
        for _ in range(3):  # capture, freeze, replay
            w.fence()
            w.put(buf, target=1)
            w.accumulate(buf, target=1)
            buf[:] = -7.0  # reused before the close
            w.fence_end()
            out.append(w.read())
            buf[:] = 2.0
        w.free()
        return out

    _, t = both(worlds, script)
    assert (obs(t[-1])[1] == 4.0).all()


def test_spanning_comm_raises_not_available(worlds):
    """A communicator spanning processes gets the wire window
    (``osc/wire_win.py``, held in ``tests/test_torch_wire_win.py``):
    without the runtime's wire router it is refused with ERR_WIN, as a
    direct ``Window()`` over it is, and a dynamic window's regions are
    wire windows too."""
    import torch

    class Runtime:
        wire = None

    class Spanning:
        spans_processes = True
        name = "spanning"
        size = N
        local_comm_ranks = [0, 1]
        device = torch.device("cpu")
        runtime = Runtime()

    dyn = tosc.win_create_dynamic(Spanning())
    for call in (lambda: tosc.win_allocate(Spanning(), (2,)),
                 lambda: tosc.win_create(Spanning(), np.zeros((2, 2))),
                 lambda: tosc.Window(Spanning(), torch.zeros(N, 2)),
                 lambda: dyn.attach((2,))):
        with pytest.raises(TMPIError) as ei:
            call()
        assert ei.value.code.name == "ERR_WIN"


def test_concurrent_closes_on_one_window(worlds):
    """Threads posting accumulates and closing epochs on one window lose
    no update (the pending queue and its apply are atomic)."""
    import sys
    import threading

    world = worlds[1]
    w = tosc.win_allocate(world, (2,), np.int32)
    w.lock_all()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def worker(pe):
            for _ in range(50):
                w.accumulate(np.ones(2, np.int32), target=0)
                w.flush(0)

        threads = [threading.Thread(target=worker, args=(pe,))
                   for pe in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    w.unlock_all()
    assert w.read()[0].tolist() == [300, 300]
    w.free()
