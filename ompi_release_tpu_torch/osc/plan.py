"""Frozen RMA access plans, in-process half — the one-sided analogue of
``coll/plan.py``.

Counterpart of ``ompi_release_tpu/osc/plan.py:1-330``. One-sided
workloads (parameter-server updates, KV-cache fills, SHMEM counter
loops) close the SAME epoch shape over and over, so this module freezes
per-(window, epoch-signature) **access plans**:

- the signature is the epoch's op sequence as hashable metadata — (kind,
  target, payload shape/dtype, the frozen Op OBJECT, compare, index,
  read-request flag) per op — derived with ``coll/plan.py``'s
  ``arg_desc``, so a same-named user op can never alias a predefined
  op's plan;
- a plan is the epoch's close unrolled: targets, branches and indices
  are fixed, payloads arrive as arguments, and each op runs the very
  ``Window._branch_fn`` the interpreted close runs, so replays are
  BITWISE the interpreted close. On the CPU the plan calls the unrolled
  close. On the card its first replay captures the unrolled close as a
  ``torch.cuda.CUDAGraph`` and every replay replays it: the payloads go
  into static input tensors allocated outside the graph's pool, the
  window's storage is written in place, and the reads land in static
  outputs that each replay copies before the requests complete. Each
  plan's graph has a memory pool of its own, so a plan's memory dies
  with the plan (a cvar write, a divergence, the window's free) and a
  pool whose graphs died is never captured into again. A capture that
  fails (a user op that syncs with the host, say) leaves the plan
  interpreted: its reason stays in ``plan.bad`` and counts in
  ``osc_graph_capture_failures``;
- plans are generation-stamped against the MCA write generation exactly
  like collective plans: any cvar write re-plans at the next epoch
  close. The first close of a new signature runs the interpreted program
  (the capturing run); a replay that raises drops the plan loudly and
  re-records at the next close.

Plans live on the window (``win._access_plans``) and are evicted at
``win.free()``. Callers hold the window's ``_op_lock``; device work runs
under ``window._dispatch_lock``.

For the spanning window's remote side, :class:`BatchTemplate`
precomposes a batch signature's wire request records (the per-op meta
JSON) at freeze time and re-renders only the payload arrays, so a frame
is byte-identical to ``osc/wire_win._pack_batch``'s; a home applies an
arriving batch through the same access-plan cache (``close_epoch``), so
a peer's steady-state epochs replay as CUDA graphs on the card.

With obs on, a replayed close is one ``rma_epoch_replay`` span and one
fixed-size ``KIND_RMA`` flight-recorder record, both taken around the
graph replay (a captured graph runs no host code).
"""

from __future__ import annotations

import time as _time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import obs as _obs
from ..btl.components import payload_nbytes
from ..coll.plan import arg_desc, capture_graph
from ..mca import pvar
from ..mca import var as mca_var
from ..obs import ledger as _ledger
from ..request.request import Status
from ..utils import output

_log = output.stream("osc")


def register_vars() -> None:
    mca_var.register(
        "osc_compiled", "bool", True,
        "Freeze per-(window, epoch-signature) RMA access plans: a "
        "repeated epoch replays its unrolled close (on the card a CUDA "
        "graph) instead of re-interpreting the pending queue "
        "(osc/plan); false keeps every close on the interpreted program",
    )
    mca_var.register(
        "osc_plan_max_ops", "int", 128,
        "Largest epoch (pending-op count) eligible for a frozen access "
        "plan — the close is unrolled, so this bounds a plan's size; "
        "larger epochs stay interpreted",
    )


register_vars()

_plan_hits = pvar.aggregate(
    "osc_plan_cache_hits",
    "plannable RMA closes served by a frozen access plan (1) vs "
    "capturing/re-freezing runs (0) — sum/count = steady-state ratio",
)
_plans_frozen = pvar.counter(
    "osc_plans_frozen", "RMA access plans frozen (one per new "
    "(window, epoch signature))",
)
_plan_programs = pvar.counter(
    "osc_plan_programs",
    "unrolled epoch closes built (first replay of a frozen plan)",
)
_orch = pvar.timer(
    "osc_orchestration_seconds",
    "host time from epoch-close entry to the device work's handoff "
    "(both the interpreted and the planned path feed it)",
)
_templates_frozen = pvar.counter(
    "osc_batch_templates_frozen",
    "remote-batch wire frame templates frozen (one per new (window, "
    "batch signature))",
)
_capture_failures = pvar.counter(
    "osc_graph_capture_failures",
    "epoch plans whose close could not be captured as a CUDA graph "
    "(they stay interpreted)",
)

#: generation-cached cvar snapshot: (generation, enabled, max_ops) —
#: steady-state closes cost one attribute read + int compare, never a
#: registry lookup
_conf: Tuple[int, bool, int] = (-1, True, 128)


def _refresh_conf() -> Tuple[int, bool, int]:
    global _conf
    gen = mca_var.VARS.generation
    if _conf[0] != gen:
        _conf = (
            gen,
            bool(mca_var.get("osc_compiled", True)),
            int(mca_var.get("osc_plan_max_ops", 128) or 0),
        )
    return _conf


def orch_add(seconds: float) -> None:
    """Interpreted-path hook: ``_run_epoch_program`` reports its
    orchestration span here so planned and interpreted closes are
    measured identically."""
    _orch.add(seconds)


# ---------------------------------------------------------------------------
# epoch signatures
# ---------------------------------------------------------------------------

def epoch_signature(todo: List) -> Optional[Tuple]:
    """Hashable signature of one epoch's op sequence, or None when any
    op is unplannable (an unhashable payload or op). The sequence is
    ordered — ops on overlapping targets must replay in submission order
    (MPI same-origin ordering), so order is part of the identity."""
    sig = []
    for p in todo:
        descs = []
        for v in (p.data, p.op, p.compare):
            d = None if v is None else arg_desc(v)
            if v is not None and d is None:
                return None
            descs.append(d)
        sig.append((p.kind, int(p.target), *descs,
                    -1 if p.index is None else int(p.index),
                    p.request is not None))
    return tuple(sig)


# ---------------------------------------------------------------------------
# the frozen plan
# ---------------------------------------------------------------------------

class _CaptureFailed(Exception):
    pass


class EpochPlan:
    """One frozen access plan: the epoch's op metadata baked into an
    unrolled close over the window's storage. ``steps`` holds per op
    (kind, target, has_data, has_compare, index, op, has_request) —
    everything but the payloads, which arrive at replay. On the card
    ``graph`` is the close captured at the first replay, reading
    ``static_in`` and writing ``static_out``."""

    __slots__ = ("gen", "sig", "steps", "prog", "graph", "static_in",
                 "static_out", "launches", "bad", "nbytes", "lid")

    def __init__(self, gen: int, sig: Tuple, todo: List) -> None:
        self.gen = gen
        self.sig = sig
        #: payload bytes one replay carries (the ledger's record size)
        self.nbytes = sum(payload_nbytes(p.data)
                          + payload_nbytes(p.compare) for p in todo)
        #: ledger plan id, registered at the first OBSERVED replay
        self.lid: Optional[int] = None
        self.steps = tuple(
            (p.kind, int(p.target), p.data is not None,
             p.compare is not None,
             -1 if p.index is None else int(p.index), p.op,
             p.request is not None)
            for p in todo
        )
        self.prog = None  # built at the first replay
        self.graph = None
        self.bad: Optional[str] = None  # why the close is no graph

    def _build(self, win):
        """The unrolled close ``(data, *payloads) -> reads``: targets,
        branches and indices are constants, and each op reuses the SAME
        branch function the interpreted close dispatches through — so
        replays are bitwise the interpreted close."""
        from .window import Window, _cast, _pre_op_read

        fns = []
        for (kind, _t, _hd, _hc, index, op, _hr) in self.steps:
            bkind = "acc" if kind in ("acc", "get_acc") else kind
            fns.append(Window._branch_fn((bkind, op, index >= 0), op))
        steps = self.steps
        # the window's dtype and slot shape, not the window: a plan must
        # not keep its window alive
        dtype, block = win.dtype, win.shape

        def unrolled(data, *bufs):
            reads = []
            bi = 0
            for fn, (_k, tgt, has_d, has_c, idx, _op, has_r) in zip(
                    fns, steps):
                pay = cmp = None
                if has_d:
                    pay = _cast(bufs[bi], dtype, block)
                    bi += 1
                if has_c:
                    cmp = _cast(bufs[bi], dtype, block)
                    bi += 1
                slot = data[tgt]
                if has_r:
                    reads.append(_pre_op_read(slot,
                                              idx if idx >= 0 else None))
                fn(slot, pay, cmp, max(idx, 0))
            return reads

        _plan_programs.add()
        return unrolled

    def _capture(self, win, args: List[torch.Tensor]) -> None:
        """Capture the unrolled close as a graph in a pool of its own;
        raises :class:`_CaptureFailed` with the reason."""
        static_in = [a.clone() for a in args]
        data = win._data
        try:
            graph, out, launches, _ = capture_graph(
                lambda: self.prog(data, *static_in), data.device,
                torch.cuda.graph_pool_handle())
        except Exception as e:
            raise _CaptureFailed(f"{type(e).__name__}: {e}") from e
        self.graph, self.static_in, self.static_out = graph, static_in, out
        self.launches = launches

    def replay(self, win, todo: List, t0: float) -> None:
        """Run the frozen close for one epoch and complete its read
        requests. Caller holds ``win._op_lock``; raises on any
        divergence before the window is written (the caller drops the
        plan)."""
        from ..ops import cuda_op
        from .window import _dispatch_lock, _epoch_dispatches

        prog = self.prog
        if prog is None:
            prog = self.prog = self._build(win)
        args = []
        for p in todo:
            if p.data is not None:
                args.append(p.data)
            if p.compare is not None:
                args.append(p.compare)
        _orch.add(_time.perf_counter() - t0)
        with _dispatch_lock:
            _epoch_dispatches.add()
            if not win._data.is_cuda:
                reads = prog(win._data, *args)
            else:
                if self.graph is None:
                    self._capture(win, args)
                else:
                    for si, a in zip(self.static_in, args):
                        si.copy_(a)
                self.graph.replay()
                cuda_op.count_replay(self.launches)
                reads = [o.clone() for o in self.static_out]
        ri = iter(reads)
        for p in todo:
            if p.request is not None:
                p.request.complete(value=next(ri),
                                   status=Status(source=p.source))


def close_epoch(win, todo: List, t0: float) -> bool:
    """Close one epoch through the access-plan cache. True = a frozen
    plan replayed (requests completed, the window written); False = the
    caller must run the interpreted epoch program — plans are off or the
    epoch unplannable, this close is the capturing run of a freshly
    frozen plan, or the plan's close could not be captured."""
    gen, enabled, max_ops = _refresh_conf()
    if not enabled or not todo or len(todo) > max_ops:
        return False
    sig = epoch_signature(todo)
    if sig is None:
        return False
    plans = win._access_plans
    plan = plans.get(sig)
    if plan is not None and plan.gen == gen:
        if plan.bad is not None:
            return False
        try:
            plan.replay(win, todo, t0)
        except _CaptureFailed as e:
            plan.bad = f"CUDA-graph capture failed: {e}"
            _capture_failures.add()
            _log.verbose(1, f"RMA access plan on {win.name} stays "
                            f"interpreted: {plan.bad}")
            return False
        except Exception as e:
            # divergence: drop the plan LOUDLY and re-record at the next
            # close; this close falls back to the interpreted program
            # (the replay raised before writing the window)
            plans.pop(sig, None)
            _log.verbose(
                1, f"dropping diverged RMA access plan on {win.name}: "
                   f"{type(e).__name__}: {e}; re-recording")
            return False
        _plan_hits.observe(1)
        if _obs.enabled:
            t1 = _time.perf_counter()
            lid = plan.lid
            if lid is None:
                lid = plan.lid = _ledger.register_rma_plan(
                    win.comm.cid, f"epoch[{len(todo)}]", plan.nbytes,
                    sig)
            _ledger.record_fire(_ledger.KIND_RMA, lid, win.comm.cid,
                                t0, t1)
            _obs.record("rma_epoch_replay", "osc", t0, t1 - t0,
                        nbytes=plan.nbytes, comm_id=win.comm.cid)
        return True
    # first sight (or stale generation): freeze now, capture via the
    # interpreted program this close
    plans[sig] = EpochPlan(gen, sig, todo)
    _plans_frozen.add()
    _plan_hits.observe(0)
    return False


# ---------------------------------------------------------------------------
# plan-time wire frames (the remote side)
# ---------------------------------------------------------------------------

class BatchTemplate:
    """Precomposed wire frame for one remote-batch signature: the per-op
    request records (the meta JSON ``_pack_batch`` builds per call) are
    composed ONCE at freeze time; :meth:`render` packs only the payload
    arrays through the same deterministic writer, so the frame is
    byte-identical to ``_pack_batch``'s."""

    __slots__ = ("gen", "meta_arr", "picks")

    def __init__(self, gen: int, todo: List) -> None:
        from .wire_win import _meta_array

        self.gen = gen
        self.meta_arr = _meta_array(todo)
        self.picks = tuple(
            (i, p.data is not None, p.compare is not None)
            for i, p in enumerate(todo)
        )

    def render(self, todo: List) -> np.ndarray:
        from .wire_win import _savez_bytes, _wire_array

        arrays = {}
        for i, has_d, has_c in self.picks:
            p = todo[i]
            if has_d:
                arrays[f"d{i}"] = _wire_array(p.data)
            if has_c:
                arrays[f"c{i}"] = _wire_array(p.compare)
        arrays["meta"] = self.meta_arr
        return np.frombuffer(_savez_bytes(arrays), dtype=np.uint8)


def batch_payload(win, todo: List) -> np.ndarray:
    """Serialize one remote batch: render the signature's frozen
    :class:`BatchTemplate` in steady state, else pack interpreted and
    freeze. The bytes are identical either way."""
    from .wire_win import _pack_batch

    gen, enabled, max_ops = _refresh_conf()
    if not enabled or len(todo) > max_ops:
        return _pack_batch(todo)
    sig = epoch_signature(todo)
    if sig is None:
        return _pack_batch(todo)
    tpls = win._batch_templates
    tpl = tpls.get(sig)
    if tpl is not None and tpl.gen == gen:
        _plan_hits.observe(1)
        return tpl.render(todo)
    # the interpreted pack runs first: it owns the predefined-op check,
    # so an unshippable batch raises before any freeze
    payload = _pack_batch(todo)
    tpls[sig] = BatchTemplate(gen, todo)
    _templates_frozen.add()
    _plan_hits.observe(0)
    return payload


# ---------------------------------------------------------------------------
# operator surface
# ---------------------------------------------------------------------------

def cache_stats() -> dict:
    """Operator-visible plan-cache counters. Plans live per window, so
    totals are the monotone freeze/build counters, not a live census."""
    st = _plan_hits.read()
    return {
        "epoch_plans": int(_plans_frozen.read()),
        "batch_templates": int(_templates_frozen.read()),
        "programs": int(_plan_programs.read()),
        "fires": int(st["count"]),
        "hits": int(st["sum"]),
    }


def _reset_for_tests() -> None:
    global _conf
    _conf = (-1, True, 128)
