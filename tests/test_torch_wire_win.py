"""The port's spanning one-sided plane (``osc/wire_win.py``, the wire half
of ``osc/plan.py``) and cross-process SHMEM held against the JAX
package.

The parity jobs (the harness of ``tests/test_torch_unified_world.py``:
one app body through the JAX package's ``Job`` and the port's, the
workers' npz dumps compared bitwise) cover:

- ``tests/test_unified_world.py``'s cross-process RMA cases: fence
  put/accumulate/get/fetch_and_op/rput/CAS across the boundary (``:511``)
  and a ``win_create`` window over each process's own buffers,
  the PSCW epoch with ``test()`` (``:591``), exclusive-lock exclusion
  (``:640``), SHMEM between PEs of different processes with the
  ``shmem_ptr`` refusal (``:675``), concurrent fetch-adds from two
  threads per process (``:913``) and the three-process battery of
  v-collectives, two remote lock contenders and a two-accessor PSCW
  (``:961``);
- ``tests/test_wire_pipeline.py:344``: two threads, two windows, a
  deferred remote lock grant that only another thread's put releases;
- ``TestOscPlanJob`` of ``tests/test_osc_plan.py``: a repeated lock
  epoch whose home side replays its frozen plan, bitwise the first.

In-process, ``TestFrameTemplates``' cases (and the wire rule that a
same-named user op is refused) hold the port's frames byte-identical to
the JAX package's ``_pack_batch`` for the same ops, in f32, int32 and
bf16. A cross-process bf16 window shows the one difference: the JAX
package's home cannot apply a batch whose payload is a 2-byte void array
(``jnp.asarray`` refuses it, so its origin's unlock raises
``ERR_RMA_SYNC``), while the port reads the words as bf16.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ompi_release_tpu import ops as jops
from ompi_release_tpu.mca import var as jvar
from ompi_release_tpu.ops.op import Op as JOp
from ompi_release_tpu.osc import plan as jplan
from ompi_release_tpu.osc.wire_win import (
    _pack_batch as jpack, _pack_reads as jpack_reads,
    _savez_bytes as jsavez)
from ompi_release_tpu.osc.window import _PendingOp as JPendingOp
from ompi_release_tpu.request.request import Request as JRequest
from ompi_release_tpu.utils.errors import ErrorCode as JErrorCode
from ompi_release_tpu_torch import ops as tops
from ompi_release_tpu_torch.mca import var as tvar
from ompi_release_tpu_torch.ops.op import Op as TOp
from ompi_release_tpu_torch.osc import plan as tplan
from ompi_release_tpu_torch.osc.wire_win import (
    OscTuning, _pack_batch, _pack_reads, _savez_bytes, _unpack_batch,
    _unpack_reads)
from ompi_release_tpu_torch.osc.window import _PendingOp
from ompi_release_tpu_torch.request.request import Request
from ompi_release_tpu_torch.utils.errors import MPIError

from test_torch_unified_world import _assert_bitwise_each, _parity

# ---------------------------------------------------------------------------
# the two-process job: every cross-process RMA/SHMEM case of the reference
# ---------------------------------------------------------------------------

RMA_BODY = """
import importlib, threading, time
OUT = {}
MOD = "ompi_release_tpu" if PKG == "jax" else "ompi_release_tpu_torch"
W = importlib.import_module(MOD + ".osc.window")
G = importlib.import_module(MOD + ".comm.group")
shmem = importlib.import_module(MOD + ".oshmem.shmem")
world = init()
rt = Runtime.current()
off = rt.local_rank_offset
n = world.size

# -- fence parity (test_unified_world.py:511) --------------------------
win = W.win_allocate(world, (4,), np.float32)
win.fence()
if off == 0:
    win.put(np.full(4, 7.0, np.float32), 5)
    win.accumulate(np.full(4, 2.0, np.float32), 6)
    win.put(np.full(4, 1.5, np.float32), 1)
else:
    win.accumulate(np.full(4, 3.0, np.float32), 2)
win.fence_end()
OUT["fence_after_epoch"] = npy(win.read())
if off == 0:
    win.lock(5)
    req = win.get(5)
    win.unlock(5)
    OUT["fence_remote_get"] = npy(req.value)
    assert req.status.source == 5
    win.lock(6)
    req = win.fetch_and_op(np.full(4, 1.0, np.float32), 6)
    win.flush(6)
    OUT["fence_fetch_old"] = npy(req.value)
    win.unlock(6)
    win.lock(5)
    rr = win.rput(np.full(4, 1.25, np.float32), 5)
    assert not rr.is_complete
    win.flush(5)
    assert rr.is_complete
    win.unlock(5)
world.barrier()
if off == 4:
    win.lock(1)
    req = win.compare_and_swap(np.float32(9.0), np.float32(1.5), 1,
                               index=2)
    win.unlock(1)
    OUT["fence_cas_old"] = npy(req.value)
world.barrier()
OUT["fence_final"] = npy(win.read())
win.free()

# -- win_create over this process's buffers, read from the other one ---
base = np.stack([np.full(4, 10.0 * (off + i), np.float32) for i in range(4)])
wc = W.win_create(world, base)
wc.lock(7 - off)
g = wc.get(7 - off)
wc.unlock(7 - off)
OUT["create_remote_get"] = npy(g.value)
wc.free()

# -- PSCW with test() (test_unified_world.py:591) -----------------------
win = W.win_allocate(world, (4,), np.float32)
origins, targets = G.Group([0, 1, 2, 3]), G.Group([4, 5, 6, 7])
if off == 0:
    win.start(targets)
    win.put(np.full(4, 5.5, np.float32), 5)
    req = win.get(6)
    win.complete()
    OUT["pscw_get"] = npy(req.value)
    win.post(targets)
    win.wait()
else:
    win.post(origins)
    deadline = time.monotonic() + 60
    while not win.test():
        assert time.monotonic() < deadline, "test() never true"
        time.sleep(0.01)
    OUT["pscw_exposed"] = npy(win.read())
    win.start(origins)
    win.accumulate(np.full(4, 8.25, np.float32), 2)
    win.complete()
world.barrier()
OUT["pscw_final"] = npy(win.read())
win.free()

# -- exclusive-lock exclusion (test_unified_world.py:640) ---------------
win = W.win_allocate(world, (1,), np.int32)
world.barrier()
for _ in range(10):
    win.lock(0)
    req = win.get(0)
    win.flush(0)
    cur = int(npy(req.value)[0])
    win.put(np.int32([cur + 1]), 0)
    win.unlock(0)
world.barrier()
if off == 0:
    OUT["lock_total"] = npy(win.read())
    assert int(OUT["lock_total"][0, 0]) == 20, OUT["lock_total"]
win.free()

# -- repeated lock epochs replay the home's frozen plan (TestOscPlanJob) -
pv = pvar.PVARS.lookup("osc_plan_cache_hits")
hits0 = pv.read()["sum"]
w = W.win_allocate(world, (4,), np.float32)
tgt = (off + 4) % n
pay = np.full(4, float(off + 1), np.float32)

def one():
    w.lock(tgt, W.LOCK_EXCLUSIVE)
    w.put(pay, target=tgt)
    w.accumulate(pay, target=tgt, op=ops.SUM)
    g = w.get(target=tgt)
    w.unlock(tgt)
    return npy(g.value)

first = one()
for _ in range(6):
    assert one().tobytes() == first.tobytes()
world.barrier()
OUT["plans_first"] = first
OUT["plans_home_row"] = npy(w.read())[0]
hits = np.zeros((4, 1), np.float32)
hits[0, 0] = pv.read()["sum"] - hits0
fires = float(npy(world.allreduce(hits))[0, 0])
assert fires >= 6, fires
w.free()

# -- SHMEM across processes (test_unified_world.py:675) -----------------
ctx = shmem.shmem_init(world)
sym = ctx.malloc((3,), np.float32)
world.barrier()
if off == 0:
    ctx.put(sym, np.asarray([1., 2., 3.], np.float32), 6)
    ctx.quiet()
    world.barrier()
    world.barrier()
    OUT["shmem_fetch_old"] = npy(ctx.atomic_fetch_add(
        sym, np.ones(3, np.float32), 6))
    try:
        sym.local(6)
        raise SystemExit("FAIL: shmem_ptr crossed processes")
    except MPIError as e:
        OUT["shmem_ptr_error"] = np.int32(int(e.code))
    OUT["shmem_local"] = npy(sym.local(1))
    world.barrier()
else:
    world.barrier()
    OUT["shmem_get"] = npy(ctx.get(sym, 6))
    world.barrier()
    world.barrier()
    OUT["shmem_get2"] = npy(ctx.get(sym, 6))
world.barrier()

# -- concurrent AMOs from two threads (test_unified_world.py:913) -------
counter = ctx.malloc((1,), np.int32)
world.barrier()
N = 12
fetched = []
flock = threading.Lock()

def shower():
    for _ in range(N):
        old = npy(ctx.atomic_fetch_add(counter, np.ones(1, np.int32), 0))
        with flock:
            fetched.append(int(old[0]))

ts = [threading.Thread(target=shower) for _ in range(2)]
for t in ts:
    t.start()
for t in ts:
    t.join()
world.barrier()
if off == 0:
    OUT["amo_total"] = npy(ctx.get(counter, 0))
    assert int(OUT["amo_total"][0]) == 4 * N
assert len(set(fetched)) == len(fetched) == 2 * N
OUT["amo_distinct"] = np.int32(len(set(fetched)))
world.barrier()

# -- two threads, two windows, a deferred grant (test_wire_pipeline:344) -
win_a = W.win_allocate(world, (1,), np.int32)
win_b = W.win_allocate(world, (1,), np.int32)
t0 = time.monotonic()
if off == 4:
    win_b.lock(5)
    world.barrier()
    deadline = time.monotonic() + 90
    while time.monotonic() < deadline:
        if int(npy(win_a.read())[0, 0]) == 42:
            break
        time.sleep(0.01)
    else:
        raise SystemExit("FAIL: window-A put never landed")
    win_b.unlock(5)
else:
    world.barrier()
    errs = []

    def t2_fn():
        try:
            win_b.lock(5)
            win_b.unlock(5)
        except Exception as e:
            errs.append(e)

    def t1_fn():
        try:
            time.sleep(0.3)
            win_a.lock(4)
            win_a.put(np.int32([42]), 4)
            win_a.unlock(4)
        except Exception as e:
            errs.append(e)

    ths = [threading.Thread(target=t2_fn), threading.Thread(target=t1_fn)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    assert not errs, errs
assert time.monotonic() - t0 < 60
world.barrier()
OUT["winlock_a"] = npy(win_a.read())
win_b.free()
win_a.free()

# -- a bf16 window across the boundary: the one difference --------------
wb = W.win_allocate(world, (4,), ml_dtypes.bfloat16 if PKG == "jax"
                    else torch.bfloat16)
world.barrier()
if off == 0:
    pay = np.asarray([1.5, -2.0, 3.25, 0.5], np.float32).astype(
        ml_dtypes.bfloat16)
    wb.lock(5)
    wb.put(pay, 5)
    try:
        wb.unlock(5)
        wb.lock(5)
        req = wb.get(5)
        wb.unlock(5)
        OUT["bf16_get"] = npy(req.value)
    except MPIError as e:
        OUT["bf16_error"] = np.int32(int(e.code))
world.barrier()
if off == 4:
    OUT["bf16_home"] = npy(wb.read())
world.barrier()
wb.free()
world.barrier()
mpi.finalize()
"""


@pytest.fixture(scope="module")
def rma(tmp_path_factory):
    return _parity(tmp_path_factory, RMA_BODY, "wire_win_rma")


@pytest.mark.parametrize("case", ["fence", "create", "pscw", "lock",
                                  "plans", "shmem", "amo", "winlock"])
def test_cross_process_rma_parity(rma, case):
    _assert_bitwise_each(rma, case + "_")


def test_cross_process_rma_closed_forms(rma):
    t0, t1 = rma["torch"]
    np.testing.assert_array_equal(t0["fence_remote_get"], np.full(4, 7.0))
    np.testing.assert_array_equal(t0["fence_fetch_old"], np.full(4, 2.0))
    np.testing.assert_array_equal(t1["fence_cas_old"], np.float32(1.5))
    np.testing.assert_array_equal(t0["create_remote_get"], np.full(4, 70.0))
    np.testing.assert_array_equal(t1["create_remote_get"], np.full(4, 30.0))
    np.testing.assert_array_equal(t0["fence_final"][1],
                                  [1.5, 1.5, 9.0, 1.5])
    np.testing.assert_array_equal(t1["pscw_exposed"][1], np.full(4, 5.5))
    np.testing.assert_array_equal(t0["pscw_final"][2], np.full(4, 8.25))
    np.testing.assert_array_equal(t1["shmem_get2"], [2.0, 3.0, 4.0])
    assert int(t0["amo_total"][0]) == 48
    assert int(t0["shmem_ptr_error"]) == int(JErrorCode.ERR_RMA_SHARED)


def test_bf16_window_across_processes_differs_from_reference(rma):
    """The JAX package's home cannot apply a bf16 batch (its payload
    arrives as a 2-byte void array, which ``jnp.asarray`` refuses): its
    origin's unlock raises ERR_RMA_SYNC and the home row stays zero. The
    port applies the words as bf16: the remote get returns the put."""
    jd0, jd1 = rma["jax"]
    td0, td1 = rma["torch"]
    assert int(jd0["bf16_error"]) == int(JErrorCode.ERR_RMA_SYNC)
    assert not jd1["bf16_home"].any()
    want = np.asarray([1.5, -2.0, 3.25, 0.5], np.float32)
    got = torch.from_numpy(td0["bf16_get"].view(np.int16)).view(
        torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, want)
    assert td1["bf16_home"][1].tobytes() == td0["bf16_get"].tobytes()


# ---------------------------------------------------------------------------
# the three-process battery (test_unified_world.py:961)
# ---------------------------------------------------------------------------

P3_BODY = """
import importlib
OUT = {}
MOD = "ompi_release_tpu" if PKG == "jax" else "ompi_release_tpu_torch"
W = importlib.import_module(MOD + ".osc.window")
G = importlib.import_module(MOD + ".comm.group")
world = init()
rt = Runtime.current()
off = rt.local_rank_offset
n = world.size
assert n == 6, n
c = np.asarray([[(i + 2 * j) % 3 for j in range(n)] for i in range(n)],
               np.int64)
sb = [np.concatenate([np.full(c[i, j], 10 * i + j, np.int32)
                      for j in range(n)]) for i in range(off, off + 2)]
rv = world.alltoallv(sb, c)
for pos in range(2):
    OUT[f"p3_alltoallv_{pos}"] = npy(rv[pos])
rc = [r + 1 for r in range(n)]
tot = sum(rc)
x = np.stack([np.arange(tot, dtype=np.int32) * (off + i + 1)
              for i in range(2)])
rs = world.reduce_scatter(x, rc)
for i in range(2):
    OUT[f"p3_reduce_scatter_{i}"] = npy(rs[i])
win = W.win_allocate(world, (1,), np.int32)
world.barrier()
if off != 0:
    for _ in range(8):
        win.lock(0)
        req = win.get(0)
        win.flush(0)
        cur = int(npy(req.value)[0])
        win.put(np.int32([cur + 1]), 0)
        win.unlock(0)
world.barrier()
if off == 0:
    OUT["p3_lock_total"] = npy(win.read())
    assert int(OUT["p3_lock_total"][0, 0]) == 16
if off == 0:
    win.post(G.Group([2, 3, 4, 5]))
    win.wait()
    OUT["p3_pscw"] = npy(win.read())
    assert int(OUT["p3_pscw"][1, 0]) == 6
else:
    win.start(G.Group([0, 1]))
    win.accumulate(np.int32([off]), 1)
    win.complete()
world.barrier()
win.free()
world.barrier()
mpi.finalize()
"""


def test_three_process_vcoll_rma_pscw(tmp_path_factory):
    dumps = _parity(tmp_path_factory, P3_BODY, "wire_win_p3", n=3, nvirt=2)
    _assert_bitwise_each(dumps, "p3_")


# ---------------------------------------------------------------------------
# frames (TestFrameTemplates of tests/test_osc_plan.py)
# ---------------------------------------------------------------------------

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "int32": (jnp.int32, torch.int32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _todos(name):
    jd, td = _DTYPES[name]
    base = np.arange(4).astype(np.float32)

    def jx(v):
        return jnp.asarray(np.asarray(v, np.float32)).astype(jd)

    def tx(v):
        return torch.tensor(np.asarray(v, np.float32)).to(td)

    j = [JPendingOp("put", 1, data=jx(base), op=jops.REPLACE),
         JPendingOp("acc", 2, data=jx(np.full(4, 2.0)), op=jops.SUM),
         JPendingOp("get", 1, request=JRequest()),
         JPendingOp("cas", 0, data=jx(9.0), compare=jx(1.0),
                    request=JRequest(), index=2),
         JPendingOp("put", 3, data=jx(7.0), op=jops.REPLACE, index=1)]
    t = [_PendingOp("put", 1, data=tx(base), op=tops.REPLACE),
         _PendingOp("acc", 2, data=tx(np.full(4, 2.0)), op=tops.SUM),
         _PendingOp("get", 1, request=Request()),
         _PendingOp("cas", 0, data=tx(9.0), compare=tx(1.0),
                    request=Request(), index=2),
         _PendingOp("put", 3, data=tx(7.0), op=tops.REPLACE, index=1)]
    return j, t


@pytest.mark.parametrize("dtype", list(_DTYPES))
class TestFrameTemplates:
    def test_pack_batch_bytes_identical_to_reference(self, dtype):
        j, t = _todos(dtype)
        assert _pack_batch(t).tobytes() == jpack(j).tobytes()

    def test_template_bytes_identical_to_pack_batch(self, dtype):
        j, t = _todos(dtype)
        tpl = tplan.BatchTemplate(tvar.VARS.generation, t)
        jtpl = jplan.BatchTemplate(jvar.VARS.generation, j)
        assert tpl.render(t).tobytes() == _pack_batch(t).tobytes()
        assert tpl.render(t).tobytes() == jtpl.render(j).tobytes()

    def test_pack_batch_is_time_deterministic(self, dtype):
        _, t = _todos(dtype)
        assert _pack_batch(t).tobytes() == _pack_batch(t).tobytes()

    def test_template_round_trips_through_unpack(self, dtype):
        _, t = _todos(dtype)
        tpl = tplan.BatchTemplate(tvar.VARS.generation, t)
        back = _unpack_batch(tpl.render(t))
        assert [(p.kind, p.target) for p in back] == \
               [(p.kind, p.target) for p in t]
        for p, q in zip(back, t):
            assert (p.op.name if p.op else "") == \
                   (q.op.name if q.op else "")
            assert p.index == q.index
            assert (p.request is not None) == (q.request is not None)
            for a, b in ((p.data, q.data), (p.compare, q.compare)):
                assert (a is None) == (b is None)
                if b is not None:
                    assert a.dtype == b.dtype
                    assert torch.equal(a, b)

    def test_reads_bytes_identical_to_reference(self, dtype):
        jd, td = _DTYPES[dtype]
        v = np.asarray([3.0, -1.0, 0.5, 2.0], np.float32)
        want = jpack_reads([jnp.asarray(v).astype(jd)])
        got = _pack_reads([torch.tensor(v).to(td)])
        assert got.tobytes() == want.tobytes()
        back = _unpack_reads(got, 1)[0]
        assert back.dtype == td and torch.equal(back, torch.tensor(v).to(td))


def test_savez_bytes_loads_like_savez():
    import io

    arrays = {"a": np.arange(5, dtype=np.int32),
              "b": np.ones((2, 3), np.float64)}
    assert _savez_bytes(arrays) == jsavez(arrays)
    z = np.load(io.BytesIO(_savez_bytes(arrays)), allow_pickle=False)
    np.testing.assert_array_equal(z["a"], arrays["a"])
    np.testing.assert_array_equal(z["b"], arrays["b"])


def test_same_named_user_op_refused_on_the_wire():
    clobber = TOp("sum", lambda a, b: a * 0 + 99.0, commutative=True)
    todo = [_PendingOp("acc", 0, data=torch.ones(4), op=clobber)]
    with pytest.raises(MPIError):
        _pack_batch(todo)
    jclobber = JOp("sum", lambda a, b: a * 0 + 99.0, commutative=True)
    with pytest.raises(Exception):
        jpack([JPendingOp("acc", 0, data=jnp.ones((4,)), op=jclobber)])


def test_osc_tuning_snapshot_honors_wire_timeout():
    tvar.set_value("osc_request_timeout_ms", 5000)
    tvar.set_value("wire_coll_timeout_ms", 9000)
    try:
        t = OscTuning()
        assert t.request_timeout_ms == 9000
        assert t.gen == tvar.VARS.generation
    finally:
        tvar.VARS.unset("osc_request_timeout_ms")
        tvar.VARS.unset("wire_coll_timeout_ms")
    tvar.set_value("osc_request_timeout_ms", 200_000)
    try:
        assert OscTuning().request_timeout_ms == 200_000
    finally:
        tvar.VARS.unset("osc_request_timeout_ms")


def test_cache_stats_counts_templates():
    st = tplan.cache_stats()
    assert set(st) == {"epoch_plans", "batch_templates", "programs",
                       "fires", "hits"}
