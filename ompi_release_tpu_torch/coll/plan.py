"""Compiled whole-schedule collectives, in-process half: one frozen plan
per call signature, fired with no decision path.

Counterpart of ``ompi_release_tpu/coll/plan.py:1-430``. The first fire
of a signature runs the interpreted dispatch (component chain, decision
rules, cvar reads) under :mod:`coll.driver` capture, which records the
body the runner launched with its exact input and output tensors. When
that body's input is the dispatched tensor itself and its output is what
the collective returned (one launch, no extra arrays: ``plan.py:417-421``
of the reference), the body alone IS the collective, and the signature
freezes it. A later fire of the signature skips the decision path:

- on the CPU the frozen plan is the cached body itself, called on the
  dispatched tensor;
- on the card the second fire captures the body into a
  ``torch.cuda.CUDAGraph`` and replays it; later fires replay it. The
  graph reads a static input tensor allocated outside the graph's pool:
  a persistent request whose buffer already lies on the comm's device
  captures against that buffer itself, so ``start()`` copies nothing in
  (its plan, in a pool of its own, lives and dies with the request);
  any other fire copies the call's tensor into the static input unless
  pointer, shape and strides match. Every replay's output is cloned on
  the same stream before the call returns, so replays in any order
  cannot overwrite a result a caller holds. The live graphs of one
  communicator share one memory pool (``torch.cuda.graph_pool_handle``);
  once they die together (the comm freed, a generation move) the pool is
  released and never captured into again — as after a failed capture —
  so the next capture opens a fresh one. The plan holds every cached index
  tensor the body read (``coll/spmd.py``), so an eviction from the index
  cache cannot free memory the graph reads; an index-cache miss during
  the capture fails it. A capture first empties the allocator's cache
  (blocks it caches cannot be freed during a capture), which waits for
  the device: the second fire of a signature is synchronous, every
  later one is not. A body that cannot be captured (a host sync
  inside it, say) becomes the reference's ``"bad"`` entry: it stays
  interpreted and counts in ``coll_graph_capture_failures``. A replay's
  kernel launches are credited to ``cuda_op.LAUNCHES`` once per replay.

Bitwise parity with the interpreted path is structural: the frozen plan
runs the very body the interpreted path ran, on the same bits.

Invalidation: every plan is stamped with the MCA registry's write
GENERATION. Any cvar write bumps it, so the next fire re-captures with
the new values (CHANGES PR 13's rule); stale plans, whose graphs hold
device memory, are dropped when the generation moves.

Scope: plans engage only for the fixed-signature families
(``_PLANNABLE``) and only when :func:`signature_of` can describe the call
(ragged v-variants and pair ops stay interpreted). Signatures key on the
Op OBJECT: two ops sharing a name never share a plan.

pvars: ``coll_compiled_cache_hits`` (1 = a frozen plan fired, 0 = a
capturing run froze one; sum/count = the steady-state hit ratio) and
``coll_graph_capture_failures``. Not ported yet: the spanning (wire)
half (``plan.py:442-834``) waits for the multi-process slice; the obs
ledger, the watchdog contributor and ``obs_trace_sample`` wait for
``obs``.
"""

from __future__ import annotations

import threading
import time as _time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..mca import pvar
from ..mca import var as mca_var
from ..utils import output
from . import driver as _driver

_log = output.stream("coll")

#: plan-cache outcome per plannable fire: 1 = a frozen plan fired, 0 = a
#: capturing run built one. sum/count = the steady-state hit ratio.
_compiled_hits = pvar.aggregate(
    "coll_compiled_cache_hits",
    "compiled-schedule plan-cache outcome per fire (1=fired frozen "
    "plan, 0=capturing run froze one); sum/count = hit ratio",
)
_capture_failures = pvar.counter(
    "coll_graph_capture_failures",
    "frozen plans whose body could not be captured as a CUDA graph "
    "(they stay interpreted)",
)


def register_vars() -> None:
    mca_var.register(
        "coll_compiled", "bool", True,
        "Fire frozen schedule plans (the cached body, on the card a "
        "CUDA graph, per plan signature) for persistent, blocking and "
        "i-family collectives in steady state; false restores the "
        "fully interpreted per-call dispatch",
    )


register_vars()  # idempotent; the cvar must exist before first dispatch

#: collective families with fixed call signatures whose schedules are
#: deterministic functions of (comm, shapes, op, root) — the plannable
#: set. Ragged v-variants ship data-dependent structure; barrier has no
#: payload to plan.
_PLANNABLE = frozenset({
    "allreduce", "bcast", "allgather", "reduce", "gather", "scatter",
    "reduce_scatter_block", "reduce_scatter", "alltoall", "scan",
    "exscan",
})

#: (generation, coll_compiled) snapshot, re-read only when the registry
#: write generation moves
_conf = (-1, True)

_lock = threading.Lock()
#: (cid, signature) -> {"gen", "frozen"|"bad"} (a persistent request
#: whose buffer lies on the comm's device keeps its entry in its memo)
_device_plans: Dict[Tuple, Dict[str, Any]] = {}
#: the generation the cache holds plans of (stale ones are dropped)
_plans_gen = -1
#: cid -> the memory pool handle the communicator's live graphs share
_pools: Dict[int, Any] = {}


def _enabled() -> bool:
    global _conf
    gen = mca_var.VARS.generation
    if _conf[0] != gen:
        _conf = (gen, bool(mca_var.get("coll_compiled", True)))
    return _conf[1]


def clear_comm(cid: int) -> None:
    """Drop every frozen plan of one communicator and its graph pool
    (comm free: a reused cid must never fire a dead comm's plans)."""
    with _lock:
        for key in [k for k in _device_plans if k[0] == cid]:
            _device_plans.pop(key, None)
        _pools.pop(cid, None)


def cache_stats() -> Dict[str, int]:
    """Operator-visible plan-cache counters (the reference's keys; the
    spanning half is not ported, so ``spanning_plans`` is 0)."""
    st = _compiled_hits.read()
    return {
        "device_plans": len(_device_plans),
        "spanning_plans": 0,
        "fires": int(st["count"]),
        "hits": int(st["sum"]),
    }


def _reset_for_tests() -> None:
    with _lock:
        _device_plans.clear()
        _pools.clear()


def _drop_stale(gen: int) -> None:
    """Drop the plans of older generations (their graphs hold device
    memory) once per generation move."""
    global _plans_gen
    if _plans_gen == gen:
        return
    with _lock:
        stale = [k for k, e in _device_plans.items() if e["gen"] != gen]
        for key in stale:
            _device_plans.pop(key, None)
        if stale:
            _pools.clear()  # every graph died: never reuse their pools
        _plans_gen = gen


# ---------------------------------------------------------------------------
# plan signatures: hashable metadata of one collective call
# ---------------------------------------------------------------------------

def arg_desc(a) -> Optional[Tuple]:
    """One argument's plan-signature entry, or None when it makes the
    call unplannable."""
    shape = getattr(a, "shape", None)
    if shape is not None and hasattr(a, "dtype"):
        return ("arr", tuple(int(d) for d in shape), str(a.dtype))
    if a is None or isinstance(a, (bool, int, float, str)):
        return ("v", a)
    if hasattr(a, "commutative") and hasattr(a, "name"):
        # an Op: the (frozen, hashable) op itself is the key — two ops
        # sharing a name but different fns must not share a plan, and
        # holding the object keeps it alive so a recycled address can
        # never alias a dead op's plan
        try:
            hash(a)
        except TypeError:
            return None
        return ("op", a)
    if isinstance(a, (list, tuple)):
        if all(isinstance(v, (bool, int, float)) for v in a):
            return ("seq", tuple(a))
        return None  # ragged buffer lists: not plannable
    return None


def signature_of(name: str, args: Tuple,
                 kw: Optional[Dict]) -> Optional[Tuple]:
    """Hashable plan signature of one collective call, or None when the
    call is not plannable (ragged buffers, pair-op tuples, exotic
    kwargs)."""
    sig: List[Any] = [name]
    for a in args:
        d = arg_desc(a)
        if d is None:
            return None
        sig.append(d)
    for k in sorted(kw or ()):
        d = arg_desc(kw[k])
        if d is None:
            return None
        sig.append((k, d))
    return tuple(sig)


# ---------------------------------------------------------------------------
# the frozen plan: the body, and on the card its CUDA graph
# ---------------------------------------------------------------------------

def _pool(cid: int):
    with _lock:
        pool = _pools.get(cid)
        if pool is None:
            pool = _pools[cid] = torch.cuda.graph_pool_handle()
        return pool


#: held around every CUDA-graph capture of the port (collective plans
#: here, epoch plans in ``osc/plan.py``) and around every epoch close's
#: device work (``osc/window.py``): a capture takes the launches counted
#: while it runs as its graph's and empties the allocator's cache, so no
#: other thread's close may launch meanwhile
capture_lock = threading.RLock()


def capture_graph(body: Callable[[], Any], device: torch.device, pool
                  ) -> Tuple[Any, Any, Dict[str, int], List[torch.Tensor]]:
    """Capture ``body()`` on a side stream of ``device`` into a
    ``torch.cuda.CUDAGraph`` of memory pool ``pool``; returns (graph,
    body's output, the kernel launches it recorded, the cached index
    tensors it read). On failure it restores the device's default
    generator and raises: the caller must never capture into ``pool``
    again."""
    from ..ops import cuda_op
    from . import spmd

    with capture_lock, torch.cuda.device(device):
        # blocks the allocator caches cannot be freed during a capture,
        # so a capture that needs memory would fail with the card's
        # memory idle in the cache: release it first (as torch.cuda.graph
        # does; it waits for the device, once per capture)
        torch.cuda.empty_cache()
        # a capture that dies before its end leaves the device's default
        # generator in capture mode (only capture_end restores it)
        gen = torch.cuda.default_generators[device.index]
        rng = gen.clone_state()
        graph = torch.cuda.CUDAGraph()
        holds: List[torch.Tensor] = []
        before = dict(cuda_op.LAUNCHES)
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        spmd.hold_indices(holds)
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    out = body()
                finally:
                    graph.capture_end()
        except Exception:
            gen.graphsafe_set_state(rng)
            raise
        finally:
            spmd.hold_indices(None)
            launches = cuda_op.take_launches(before)
        cur.wait_stream(side)
    return graph, out, launches, holds


class _Frozen:
    """One signature's frozen body; on the card, the graph of it."""

    __slots__ = ("body", "graph", "static_in", "static_out", "holds",
                 "launches")

    def __init__(self, body: Callable) -> None:
        self.body = body
        self.graph = None

    def capture(self, x: torch.Tensor, cid: Optional[int]
                ) -> Optional[str]:
        """Capture the body on ``x``'s device into a graph of comm
        ``cid``'s shared pool; returns why it cannot be captured, or
        None. ``cid`` None: ``x`` is a persistent request's own buffer,
        read in place by every replay, and the graph gets a pool of its
        own (it dies with the request); otherwise the static input is a
        copy of ``x``."""
        static_in = x if cid is None else x.clone()
        pool = torch.cuda.graph_pool_handle() if cid is None else _pool(cid)
        try:
            graph, out, launches, holds = capture_graph(
                lambda: self.body(static_in), x.device, pool)
        except Exception as e:  # the plan stays interpreted
            _log.verbose(1, f"CUDA-graph capture failed: {e}")
            with _lock:  # the failed capture may leave the pool open
                _pools.pop(cid, None)
            return f"{type(e).__name__}: {e}"
        if not isinstance(out, torch.Tensor):
            return "the body returned no tensor"
        self.graph, self.static_in, self.static_out = graph, static_in, out
        self.holds, self.launches = holds, launches
        return None

    def fire(self, x: torch.Tensor) -> torch.Tensor:
        if self.graph is None:  # the CPU: the body itself
            return self.body(x)
        from ..ops import cuda_op

        si = self.static_in
        if not (x.data_ptr() == si.data_ptr() and x.shape == si.shape
                and x.stride() == si.stride()):
            si.copy_(x)
        self.graph.replay()
        cuda_op.count_replay(self.launches)
        return self.static_out.clone()


# ---------------------------------------------------------------------------
# in-process dispatch
# ---------------------------------------------------------------------------

def dispatch(comm, name: str, fn: Callable, args: Tuple,
             kw: Optional[Dict] = None, sig_box: Optional[list] = None,
             bound: bool = False) -> Any:
    """THE in-process collective dispatch: fire the signature's frozen
    plan when one exists (steady state — no decision logic, no cvar
    reads), else run the interpreted path under capture and freeze the
    body it launched. Plain interpreted execution when the family is
    unplannable, the call has no signature, or the capture proved the
    dispatch did pre/post-processing the body alone cannot replay.
    ``sig_box``: a persistent request's memo: its signature (the
    arguments are bound at ``*_init``, so ``start()`` skips even the
    signature build) and, when ``bound`` (the request's buffer lies on
    the comm's device and its graph reads the buffer in place), its
    plan entry."""
    t0 = _time.perf_counter()
    kw = kw or {}
    if name not in _PLANNABLE:
        return fn(comm, *args, **kw)
    if not _enabled():
        # fully interpreted (coll_compiled=false): the orchestration
        # timer still starts at THIS entry, as on the frozen leg
        _driver.orch_mark(t0)
        try:
            return fn(comm, *args, **kw)
        finally:
            _driver.orch_clear()
    if sig_box:
        sig = sig_box[0]
    else:
        sig = signature_of(name, args, kw)
        if sig_box is not None:
            sig_box.append(sig)
    if sig is None:
        return fn(comm, *args, **kw)
    gen = mca_var.VARS.generation
    _drop_stale(gen)
    x = args[0]
    key = (comm.cid, sig)
    # a bound request's plan reads the request's own buffer: it lives in
    # the request's memo and dies with the request
    e = (sig_box[1] if len(sig_box) > 1 else None) if bound \
        else _device_plans.get(key)
    if e is not None and e["gen"] == gen:
        frozen = e.get("frozen")
        if frozen is None:  # "bad": stays interpreted
            return fn(comm, *args, **kw)
        if frozen.graph is None and x.is_cuda:
            why = frozen.capture(x, None if bound else comm.cid)
            if why is not None:
                _capture_failures.add()
                del e["frozen"]
                e["bad"] = f"CUDA-graph capture failed: {why}"
                return fn(comm, *args, **kw)
        # pvar continuity: a frozen fire IS an invocation and a plan-cache
        # hit — the MPI_T series must not dip when the steady state engages
        _driver._invoke_count.add()
        _driver._plan_cache.observe(1.0)
        _compiled_hits.observe(1)
        _driver._orch.add(_time.perf_counter() - t0)
        return frozen.fire(x)
    # capture attempt: interpreted run with body-launch recording
    _driver.orch_mark(t0)  # the timer covers the decision path too
    cap = _driver.begin_capture()
    try:
        out = fn(comm, *args, **kw)
    finally:
        _driver.end_capture()
        _driver.orch_clear()
    entry: Dict[str, Any] = {"gen": gen}
    if (len(cap) == 1 and cap[0]["out"] is out and cap[0]["x"] is x
            and not cap[0]["extra"]):
        entry["frozen"] = _Frozen(cap[0]["prog"])
        _compiled_hits.observe(0)
    else:
        entry["bad"] = "the collective is not its body alone"
    if bound:
        sig_box[1:] = [entry]
    else:
        with _lock:
            _device_plans[key] = entry
    return out
