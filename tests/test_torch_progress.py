"""The port's async progress engine (``runtime/progress.py``) held against
the JAX package's on the same scripts.

Each case of ``tests/test_nbc.py``'s TestProgressEngine runs one script
on both engines and compares the traces: posting-order drain in polling
mode, the error surfacing at wait, thread mode running off the caller
with its run time in ``nbc_hidden_seconds``, polling waits hiding
nothing, ``wait_all``/``test_all`` ticking the shared progress hook once
per pass, a bare ``from_future`` wait driving the hook,
``advance_toward``'s kick rule and the ``nbc_schedules_inflight`` pvar.
Device-free: no communicator is involved.
"""

import threading
import time

import pytest

from ompi_release_tpu.mca import pvar as jpvar
from ompi_release_tpu.mca import var as jvar
from ompi_release_tpu.request import request as jreq
from ompi_release_tpu.runtime import progress as jprog
from ompi_release_tpu_torch.mca import pvar as tpvar
from ompi_release_tpu_torch.mca import var as tvar
from ompi_release_tpu_torch.request import request as treq
from ompi_release_tpu_torch.runtime import progress as tprog

PKGS = {"jax": (jprog, jpvar, jvar, jreq), "torch": (tprog, tpvar, tvar, treq)}


def both(script):
    """Run ``script(progress, pvar, var, request)`` on both engines and
    return the two traces (JAX's first)."""
    return [script(*PKGS[k]) for k in ("jax", "torch")]


def _order_script(progress, pvar, var, request):
    eng = progress.engine()
    order = []
    key = ("t-order", id(order))
    ops = [progress.ScheduledOp(key, n, lambda n=n: order.append(n) or n)
           for n in "abc"]
    other = progress.ScheduledOp(("t-order-b", id(order)), "z",
                                 lambda: order.append("z"))
    for op in ops[:2] + [other, ops[2]]:
        eng.post(op)
    trace = [("posted", [op.done.is_set() for op in ops], list(order))]
    trace.append(("wait_b", eng.wait(ops[1]), list(order),
                  [op.state for op in ops]))
    trace.append(("wait_c", eng.wait(ops[2]), list(order),
                  [op.state for op in ops] + [other.state]))
    return trace


def test_polling_drains_in_posting_order():
    """Nothing runs at post; waiting a LATER op first completes every
    earlier op this thread posted, across keys, in posting order."""
    j, t = both(_order_script)
    assert t == j
    assert t[0] == ("posted", [False, False, False], [])
    assert t[2][2] == ["a", "b", "z", "c"]


def _error_script(progress, pvar, var, request):
    eng = progress.engine()
    hits = []

    def boom():
        hits.append(1)
        raise RuntimeError("schedule died")

    op = progress.ScheduledOp(("t-err", 1), "boom", boom)
    after = progress.ScheduledOp(("t-err", 1), "after", lambda: 3)
    eng.post(op)
    eng.post(after)
    trace = []
    try:
        eng.wait(op)
    except RuntimeError as e:
        trace.append(("raised", str(e), op.state, len(hits)))
    trace.append(("after", eng.wait(after)))
    try:
        eng.wait(op)  # a second wait re-raises, never re-runs
    except RuntimeError as e:
        trace.append(("again", str(e), len(hits)))
    return trace


def test_error_surfaces_at_wait():
    j, t = both(_error_script)
    assert t == j
    assert t[0] == ("raised", "schedule died", "done", 1)


def _thread_script(progress, pvar, var, request):
    eng = progress.engine()
    hidden = pvar.PVARS.lookup("nbc_hidden_seconds")
    h0 = float(hidden.read())
    var.set_value("progress_thread", True)
    try:
        caller = threading.get_ident()
        ran_on = []
        op = progress.ScheduledOp(
            ("t-thread", 1), "bg",
            lambda: ran_on.append(threading.get_ident())
            or time.sleep(0.03) or 7)
        eng.post(op)
        done = op.done.wait(5.0)
        value = eng.wait(op)
        gained = float(hidden.read()) - h0
    finally:
        var.VARS.unset("progress_thread")
    return [done, value, ran_on[0] != caller, gained >= 0.02]


def test_thread_mode_runs_off_caller_and_hides_time():
    j, t = both(_thread_script)
    assert t == j == [True, 7, True, True]


def _expose_script(progress, pvar, var, request):
    eng = progress.engine()
    hidden = pvar.PVARS.lookup("nbc_hidden_seconds")
    op = progress.ScheduledOp(("t-expose", 1), "fg",
                              lambda: time.sleep(0.02) or 1)
    eng.post(op)
    h0 = float(hidden.read())
    value = eng.wait(op)
    return [value, float(hidden.read()) - h0, op.hidden_seconds()]


def test_polling_wait_exposes_time():
    """Polling mode: the schedule runs INSIDE wait(), so none of its
    time is hidden."""
    j, t = both(_expose_script)
    assert t == j == [1, 0.0, 0.0]


def _wait_all_script(progress, pvar, var, request):
    ticks = []
    saved = list(request._progress_hooks)
    request.register_progress_hook(lambda: ticks.append(1) or 0)
    try:
        done_reqs = []
        for _ in range(3):
            r = request.Request()
            r.complete(value=1)
            done_reqs.append(r)
        request.wait_all(done_reqs)
        trace = [len(ticks)]
        ticks.clear()
        ok, _ = request.test_all(done_reqs)
        trace += [ok, len(ticks)]
        ticks.clear()
        i, _ = request.test_any(done_reqs)
        trace += [i, len(ticks)]
    finally:
        request._progress_hooks[:] = saved
    return trace


def test_wait_all_drives_shared_hook_once_per_pass():
    j, t = both(_wait_all_script)
    assert t == j == [1, True, 1, 0, 1]


def _future_script(progress, pvar, var, request):
    from concurrent.futures import ThreadPoolExecutor

    ticks = []
    saved = list(request._progress_hooks)
    request.register_progress_hook(lambda: ticks.append(1) or 0)
    try:
        with ThreadPoolExecutor(1) as pool:
            fut = pool.submit(lambda: time.sleep(0.05) or "v")
            req = request.from_future(fut)
            st = req.wait()
        return [st is not None, req.value, bool(ticks)]
    finally:
        request._progress_hooks[:] = saved


def test_from_future_wait_drives_hook():
    j, t = both(_future_script)
    assert t == j == [True, "v", True]


def _kick_script(progress, pvar, var, request):
    eng = progress.engine()
    op = progress.ScheduledOp(("t-kick", 1), "k", lambda: 5)
    eng.post(op)
    eng.advance_toward(op)  # wait()'s single internal test
    time.sleep(0.05)
    first = op.done.is_set()
    eng.advance_toward(op)  # second consecutive poll = a real loop
    second = op.done.wait(5.0)
    return [first, second, op.polls, eng.wait(op),
            op.claimed_by != threading.get_ident()]


def test_advance_toward_kicks_background_drainer():
    """A test()-poll loop completes a queued schedule without a wait(),
    but the FIRST advance never spawns a drainer."""
    j, t = both(_kick_script)
    assert t == j == [False, True, 2, 5, True]


def _inflight_script(progress, pvar, var, request):
    eng = progress.engine()
    level = pvar.PVARS.lookup("nbc_schedules_inflight")
    base = int(level.read())
    ops = [progress.ScheduledOp(("t-level", 1), "x", lambda: 0)
           for _ in range(3)]
    trace = []
    for op in ops:
        eng.post(op)
        trace.append(int(level.read()) - base)
    trace.append([d["name"] for d in eng.snapshot()][-3:])
    eng.wait(ops[0])
    trace.append(int(level.read()) - base)
    eng.drain_key(("t-level", 1))
    trace.append(int(level.read()) - base)
    return trace


def test_inflight_pvar_tracks_registry():
    j, t = both(_inflight_script)
    assert t == j == [1, 2, 3, ["x", "x", "x"], 2, 0]


def _fail_queued_script(progress, pvar, var, request):
    eng = progress.engine()
    key = ("t-fail", 1)
    ran = []
    ops = [progress.ScheduledOp(key, str(i), lambda i=i: ran.append(i))
           for i in range(3)]
    for op in ops:
        eng.post(op)
    n = eng.fail_queued(key, lambda: RuntimeError("revoked"))
    trace = [n, ran, [op.state for op in ops]]
    for op in ops:
        try:
            eng.wait(op)
        except RuntimeError as e:
            trace.append(str(e))
    return trace


def test_fail_queued_completes_in_error_without_running():
    j, t = both(_fail_queued_script)
    assert t == j == [3, [], ["done"] * 3] + ["revoked"] * 3


def test_schedule_runs_on_its_device():
    """A schedule carrying a device runs with it current (the CPU: no
    device switch at all)."""
    import torch

    eng = tprog.engine()
    op = tprog.ScheduledOp(("t-dev", 1), "d", lambda: 9,
                           device=torch.device("cpu"))
    eng.post(op)
    assert eng.wait(op) == 9


@pytest.mark.parametrize("cvar,default", [("progress_thread", False),
                                          ("progress_poll_us", 500)])
def test_cvars_registered_like_jax(cvar, default):
    assert tvar.get(cvar) == jvar.get(cvar) == default


def test_runtime_finalize_stops_the_thread():
    """init arms the thread when the cvar is set; finalize shuts the
    engine down (the JAX runtime's init/finalize hooks)."""
    import ompi_release_tpu_torch as tmpi
    from ompi_release_tpu_torch.runtime import runtime as trt

    trt._reset_for_tests()
    tvar.set_value("progress_thread", True)
    try:
        tmpi.init(cli_args=["--mca", "runtime_virtual_ranks", "2"],
                  device="cpu")
        t = tprog.engine()._thread
        assert t is not None and t.is_alive()
        trt._reset_for_tests()
        t.join(5.0)
        assert not t.is_alive() and tprog.engine()._thread is None
    finally:
        tvar.VARS.unset("progress_thread")
        tvar.VARS.unset("runtime_virtual_ranks")
        trt._reset_for_tests()
