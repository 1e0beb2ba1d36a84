"""Compiled whole-schedule collectives: one frozen plan per call
signature, fired with no decision path.

Counterpart of ``ompi_release_tpu/coll/plan.py``. In-process half: the
first fire
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
  kernel launches (and the bytes its ``stream_axpy`` launches move) are
  credited to ``cuda_op`` once per replay.

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

Spanning (wire) half, for communicators that span processes
(``plan.py:442-834`` of the reference): the first run of a schedule
records its ROUND STRUCTURE (peer lists, per-round send shapes/dtypes,
receive counts and arrival shapes) through a :class:`RoundRecorder`
wrapped around the hier exchange adapter; :func:`freeze_wire_plan` then
resolves the wire tuning cvars ONCE and precomposes every round's SGH2
frame headers and fragment offsets
(:class:`~..btl.components.FrameTemplate`). Steady-state fires replay
through :class:`PlannedXchg` — memoryview slicing behind precomposed
header bytes, the arrival-order reap, no per-message dict lookups, tag
math or header packing — or, when :mod:`coll.native_exec` can prove
the byte provenance of every round, through the C plan executor. The
wire bytes are identical to the interpreted path's, so results are
bitwise identical and the receive side needs no changes. The schedule
body still runs in Python on every fire (its local collective on the
shadow comm, its folds on the card through ``ops.op.resolve``, so a
>= 4 MiB f32/bf16 SUM launches ``stream_axpy`` in a replay exactly as
in an interpreted call); only the exchanges are frozen. Any replay
failure drops the plan, so the next fire re-records. bf16 crosses the
hier schedules as its raw 2-byte words (numpy uint16), so its round
metadata, templates and descriptor dtypes all name ``uint16``
consistently.

pvars: ``coll_compiled_cache_hits`` (1 = a frozen plan fired, 0 = a
capturing run froze one; sum/count = the steady-state hit ratio),
``coll_graph_capture_failures`` and ``coll_wire_rounds_frozen``.

Traced layers (``obs/spans.py``; with obs on or a profiler collecting,
nothing otherwise): every :func:`dispatch` is an ``mpi.coll.<name>``
range, and a fire on the card three steps, ``mpi.plan.copy_in``,
``mpi.plan.replay`` and ``mpi.plan.clone``. Each is a range while a
profiler collects; the copies count the bytes they read and write in
``coll_plan_copy_bytes``, and the replay its host seconds inside
``graph.replay()`` in ``coll_plan_launch_seconds``. With obs on the
three are intervals of one chain of CUDA events besides: the copies
feed ``coll_plan_copy_device_seconds``, the replay
``coll_runner_device_seconds`` (``coll/driver.py``'s, which times
interpreted bodies too).

Observed fires stay on the frozen path: a device fire (a graph replay
on the card) appends one fixed-size ``KIND_DEVICE`` record to the obs
ledger around the replay — never inside the captured body, which a
graph would run once at capture and never again — and a spanning
replay one ``KIND_SPANNING`` record with its round-end clock reads,
which ``tpu-doctor`` expands into the interpreted path's exact flow
ids; the watchdog's ``frozen_plans`` contributor names the plan and round
a stalled rank is replaying.
"""

from __future__ import annotations

import threading
import time as _time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.autograd import profiler as _tprof

from .. import obs as _obs
from ..mca import pvar
from ..mca import var as mca_var
from ..obs import ledger as _ledger
from ..obs import spans as _spans
from ..obs import watchdog as _watchdog
from ..utils import output
from ..utils.errors import ErrorCode, MPIError
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
_wire_rounds_frozen = pvar.counter(
    "coll_wire_rounds_frozen",
    "schedule rounds captured into frozen wire plans (peer lists, "
    "frame headers, fragment offsets precomposed at plan time)",
)
# a frozen fire's steps on the card (the module docstring's "Traced
# layers")
_copy_device = pvar.device_timer(
    "coll_plan_copy_device_seconds",
    "device seconds of frozen plans' input copies and output clones "
    "(CUDA events; with obs on)",
)
_copy_bytes = pvar.counter(
    "coll_plan_copy_bytes",
    "bytes frozen plans' input copies and output clones read and "
    "write (with obs on or a profiler collecting)",
)
_launch_host = pvar.timer(
    "coll_plan_launch_seconds",
    "host seconds inside frozen plans' graph.replay() (the graph "
    "launch; with obs on or a profiler collecting)",
)


def register_vars() -> None:
    mca_var.register(
        "coll_compiled", "bool", True,
        "Fire frozen schedule plans (the cached body, on the card a "
        "CUDA graph, per plan signature) for persistent, blocking and "
        "i-family collectives in steady state; false restores the "
        "fully interpreted per-call dispatch",
    )
    mca_var.register(
        "coll_plan_native", "bool", True,
        "Fire eligible frozen wire plans through the native C plan "
        "executor (one ctypes slice loop walks every round: striped "
        "sends, pooled reassembly). Requires the native .so and a "
        "nativewire card on every round peer; anything else — and "
        "false — replays through the interpreted PlannedXchg path, "
        "bitwise-identical",
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

#: (generation, coll_compiled, wire_overlap_exchange) snapshot, re-read
#: only when the registry write generation moves
_conf = (-1, True, True)

_lock = threading.Lock()
#: (cid, signature) -> {"gen", "frozen"|"bad"} (a persistent request
#: whose buffer lies on the comm's device keeps its entry in its memo)
_device_plans: Dict[Tuple, Dict[str, Any]] = {}
#: the generation the cache holds plans of (stale ones are dropped)
_plans_gen = -1
#: cid -> the memory pool handle the communicator's live graphs share
_pools: Dict[int, Any] = {}
#: (cid, signature) -> SpanningPlanState
_span_states: Dict[Tuple, "SpanningPlanState"] = {}


def _refresh_conf() -> Tuple[int, bool, bool]:
    global _conf
    gen = mca_var.VARS.generation
    if _conf[0] != gen:
        _conf = (gen, bool(mca_var.get("coll_compiled", True)),
                 bool(mca_var.get("wire_overlap_exchange", True)))
    return _conf


def _enabled() -> bool:
    return _refresh_conf()[1]


def _overlap_on() -> bool:
    # the planned replay path IS the striped/overlapped send path; an
    # operator's wire_overlap_exchange=False opt-out (serialized sends)
    # keeps spanning fires fully interpreted, where _XchgAdapter
    # honours the flag
    return _refresh_conf()[2]


#: live planned replays, keyed by plan-state identity: the watchdog's
#: "frozen_plans" contributor names the plan (id, signature, round
#: index) a rank is stuck inside, instead of just raw wire waits.
#: Mutated only under an ``_obs.enabled`` gate (postmortems only fire
#: with obs on), so the unobserved hot path never touches it.
_active_replays: Dict[int, Tuple["SpanningPlanState",
                                 "PlannedXchg"]] = {}


def _frozen_plans_snapshot() -> Dict[str, Any]:
    out = []
    for st, px in list(_active_replays.values()):
        plan = px.plan
        out.append({
            "plan": plan.ledger_id, "name": st.name,
            "comm": getattr(st.comm, "name", "?"), "cid": plan.cid,
            "signature": _ledger._sig_summary(st.sig),
            "round": px.i, "rounds_total": len(plan.rounds),
        })
    return {"active_replays": out, **cache_stats()}


_watchdog.add_contributor("frozen_plans", _frozen_plans_snapshot)


def _sig_nbytes(sig: Tuple) -> int:
    """Payload bytes of a plan signature's first array argument (the
    flight recorder's per-fire byte accounting for device plans)."""
    for d in sig[1:]:
        if isinstance(d, tuple) and d and d[0] == "arr":
            n = 1
            for s in d[1]:
                n *= int(s)
            return n * _ledger._itemsize(d[2])
    return 0


def clear_comm(cid: int) -> None:
    """Drop every frozen plan of one communicator, its graph pool and
    its native executors with their reassembly pools (comm free: a
    reused cid must never fire a dead comm's plans)."""
    with _lock:
        for key in [k for k in _device_plans if k[0] == cid]:
            _device_plans.pop(key, None)
        _pools.pop(cid, None)
        gone = [_span_states.pop(k) for k in list(_span_states)
                if k[0] == cid]
    for st in gone:
        st.plan = None
        st._drop_native()


def cache_stats() -> Dict[str, int]:
    """Operator-visible plan-cache counters (the reference's keys)."""
    st = _compiled_hits.read()
    return {
        "device_plans": len(_device_plans),
        "spanning_plans": len(_span_states),
        "fires": int(st["count"]),
        "hits": int(st["sum"]),
    }


def _reset_for_tests() -> None:
    with _lock:
        _device_plans.clear()
        _pools.clear()
        gone = list(_span_states.values())
        _span_states.clear()
    for st in gone:
        st._drop_native()


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
        before = cuda_op.counts()
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
                 "launches", "copy_bytes")

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
        # what the copy-in and the clone each read and write
        self.copy_bytes = (2 * static_in.nbytes, 2 * out.nbytes)
        return None

    def fire(self, x: torch.Tensor) -> torch.Tensor:
        if self.graph is None:  # the CPU: the body itself
            return self.body(x)
        from ..ops import cuda_op

        si = self.static_in
        with (_spans.Steps(si.device)
              if _obs.enabled or _tprof._is_profiler_enabled
              else _spans.OFF) as st:
            if not (x.data_ptr() == si.data_ptr() and x.shape == si.shape
                    and x.stride() == si.stride()):
                st.step("plan", "copy_in", _copy_device, count=_copy_bytes,
                        n=self.copy_bytes[0])
                si.copy_(x)
            st.step("plan", "replay", _driver.runner_device, _launch_host)
            self.graph.replay()
            st.step("plan", "clone", _copy_device, count=_copy_bytes,
                    n=self.copy_bytes[1])
            out = self.static_out.clone()
        cuda_op.count_replay(self.launches)
        return out


# ---------------------------------------------------------------------------
# in-process dispatch
# ---------------------------------------------------------------------------

def dispatch(comm, name: str, fn: Callable, args: Tuple,
             kw: Optional[Dict] = None, sig_box: Optional[list] = None,
             bound: bool = False) -> Any:
    """THE in-process collective dispatch (:func:`_dispatch`), an
    ``mpi.coll.<name>`` span from entry to return while obs is on or a
    profiler collects (the skew timer and the ledger journal this
    interval)."""
    with (_spans.span("coll", name)
          if _obs.enabled or _tprof._is_profiler_enabled else _spans.OFF):
        return _dispatch(comm, name, fn, args, kw, sig_box, bound)


def _dispatch(comm, name: str, fn: Callable, args: Tuple,
              kw: Optional[Dict], sig_box: Optional[list],
              bound: bool) -> Any:
    """Fire the signature's frozen plan when one exists (steady state
    — no decision logic, no cvar reads), else run the interpreted path
    under capture and freeze the body it launched. Plain interpreted
    execution when the family is unplannable, the call has no
    signature, or the capture proved the dispatch did pre/post-processing
    the body alone cannot replay. ``sig_box``: a persistent request's
    memo: its signature (the arguments are bound at ``*_init``, so
    ``start()`` skips even the signature build) and, when ``bound`` (the
    request's buffer lies on the comm's device and its graph reads the
    buffer in place), its plan entry."""
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
        # the steady state — observed or not. An observed fire is
        # flight-recorded (one fixed-size ledger record, no span
        # objects).
        obs_on = _obs.enabled
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
        if not obs_on:
            return frozen.fire(x)
        # the record sits around the replay, not inside the captured
        # body: a graph runs host code once, at capture
        out = frozen.fire(x)
        lid = e.get("lid")
        if lid is None:
            lid = e["lid"] = _ledger.register_device_plan(
                comm.cid, name, _sig_nbytes(sig), sig)
        _ledger.record_fire(_ledger.KIND_DEVICE, lid, comm.cid,
                            t0, _time.perf_counter())
        return out
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
        if _obs.enabled:
            _obs.record("plan_capture_" + name, "plan", t0,
                        _time.perf_counter() - t0, comm_id=comm.cid)
    else:
        entry["bad"] = "the collective is not its body alone"
    if bound:
        sig_box[1:] = [entry]
    else:
        with _lock:
            _device_plans[key] = entry
    return out


# ---------------------------------------------------------------------------
# spanning: record the round structure, freeze the wire frames
# ---------------------------------------------------------------------------

def _as_nd(a) -> np.ndarray:
    """A schedule payload as the host array the wire carries: numpy
    passes through untouched (the common steady state: the hier
    schedules hand host arrays); a tensor is staged to the host (bf16
    as its raw 2-byte words)."""
    if isinstance(a, np.ndarray):
        return a
    if isinstance(a, torch.Tensor):
        from ..btl.components import host_payload

        return host_payload(a)[0]
    return np.asarray(a)


def _round_meta(sends: Dict[int, list]) -> Tuple:
    return tuple(
        (p, tuple((a.shape, str(a.dtype))
                  for a in map(_as_nd, sends[p])))
        for p in sorted(sends) if sends[p]
    )


class RoundRecorder:
    """Exchange-adapter wrapper: delegates every round to the real
    transport and records its structure — (peer, shape, dtype) per
    send, receive counts per peer, and the per-source arrival
    shapes/dtypes (the native executor's reassembly-pool layout;
    per-source order is deterministic: the wire is FIFO per peer)."""

    __slots__ = ("inner", "rounds", "recv_metas")

    def __init__(self, inner) -> None:
        self.inner = inner
        self.rounds: List[Tuple[Tuple, Tuple]] = []
        self.recv_metas: List[Tuple] = []

    def exchange(self, sends: Dict[int, list],
                 recvs: Dict[int, int]) -> Dict[int, list]:
        got = self.inner.exchange(sends, recvs)
        self.rounds.append((
            _round_meta(sends),
            tuple(sorted((int(p), int(c)) for p, c in recvs.items()
                         if int(c) > 0)),
        ))
        self.recv_metas.append(tuple(sorted(
            (int(src), tuple((_as_nd(a).shape, str(_as_nd(a).dtype))
                             for a in arrs))
            for src, arrs in got.items() if arrs)))
        return got


class WireRound:
    """One frozen schedule round: verification metadata plus the
    resolved send slots (peer -> per-message FrameTemplates or None
    for shm/legacy sends), channel tag, and striping depth.

    ``recvs_meta`` (per-source arrival shapes/dtypes) sizes the
    native executor's reassembly pool; ``frame_counts`` (frames per
    peer stream, header included) lets the striper skip QoS gating on
    exhausted streams. Both default None: manually-built rounds
    replay exactly as before."""

    __slots__ = ("sends_meta", "recvs_t", "recvs", "peers",
                 "peer_slots", "tag", "depth", "recvs_meta",
                 "frame_counts")

    def __init__(self, sends_meta: Tuple, recvs_t: Tuple, peer_slots,
                 tag: int, depth: int,
                 recvs_meta: Optional[Tuple] = None,
                 frame_counts: Optional[Tuple] = None) -> None:
        self.sends_meta = sends_meta
        self.recvs_t = recvs_t
        self.recvs = dict(recvs_t)
        self.peers = tuple(p for p, _ in sends_meta)
        self.peer_slots = peer_slots
        self.tag = tag
        self.depth = depth
        self.recvs_meta = recvs_meta
        self.frame_counts = frame_counts


class WirePlan:
    """Frozen wire schedule: every round's structure and precomposed
    frames (the segsize they were built from is baked into each
    :class:`~..btl.components.FrameTemplate`), plus the plan-time
    ``wire_coll_timeout_ms`` snapshot replay waits are bounded by."""

    __slots__ = ("gen", "cid", "rounds", "timeout_ms", "ledger_id")

    def __init__(self, gen: int, cid: int, rounds: List[WireRound],
                 timeout_ms: int) -> None:
        self.gen = gen
        self.cid = cid
        self.rounds = rounds
        self.timeout_ms = timeout_ms
        #: flight-recorder plan id — registered lazily at the first
        #: OBSERVED fire (obs/ledger holds the frozen round/flow
        #: structure; fires then append fixed-size records only)
        self.ledger_id: Optional[int] = None


def freeze_wire_plan(comm, recorded: List[Tuple[Tuple, Tuple]],
                     gen: int,
                     recv_metas: Optional[List[Tuple]] = None,
                     ) -> Optional[WirePlan]:
    """Resolve one recorded round structure into a frozen
    :class:`WirePlan`: wire tuning cvars snapshot once (a mid-job cvar
    write lands here, at the NEXT plan), SGH2 headers and fragment
    offsets precomposed per send slot.

    ``recv_metas`` (parallel to ``recorded``, the recorder's
    per-source arrival shapes/dtypes) is optional: plans frozen
    without it stay fully replayable, they just never graduate to the
    native executor (which needs arrival metas to size its pool)."""
    router = getattr(comm.runtime, "wire", None)
    if router is None:
        return None
    from ..btl import components as _btl

    tuning = router.refresh_tuning()
    tag = router._coll_tag(comm)
    rounds: List[WireRound] = []
    for i, item in enumerate(recorded):
        sends_meta, recvs_t = item[0], item[1]
        recvs_meta = (recv_metas[i] if recv_metas is not None
                      and i < len(recv_metas) else None)
        peer_slots = []
        frame_counts = []
        for p, arrs in sends_meta:
            tpls = []
            for shape, dtype in arrs:
                tpl = None
                btl = router._btl_for(p)
                # every segsize-framed transport precomposes: dcn's
                # interpreted SGH2 stream and nativewire's
                # scatter-gather stream share the FrameTemplate (the
                # byte-identity authority), each clamped to its OWN
                # max frame size cvar
                if tuning.segsize > 0 and (
                        btl is router._dcn
                        or (router._nw is not None
                            and btl is router._nw)):
                    seg = min(tuning.segsize,
                              max(1, btl.max_send_size))
                    tpl = _btl.plan_frame_template(shape, dtype, seg)
                tpls.append(tpl)
            peer_slots.append((p, tuple(tpls)))
            # frames a stream will emit: header + fragments for a
            # templated message, one frame otherwise — exact, so the
            # striper can drop a drained stream without gating it
            frame_counts.append(sum(
                (int(t.nchunks) + 1) if t is not None else 1
                for t in tpls))
        rounds.append(WireRound(sends_meta, recvs_t, tuple(peer_slots),
                                tag, tuning.depth,
                                recvs_meta=recvs_meta,
                                frame_counts=tuple(frame_counts)))
    _wire_rounds_frozen.add(len(rounds))
    return WirePlan(gen, comm.cid, rounds, tuning.coll_timeout_ms)


def _mismatch(module, i: int, detail: str) -> MPIError:
    return MPIError(
        ErrorCode.ERR_INTERN,
        f"compiled schedule plan diverged mid-run on "
        f"{module.comm.name} (round {i}): {detail}. The schedule no "
        "longer matches its frozen plan — rebuild the persistent "
        "request (or re-issue the collective) after changing "
        "schedule-selection cvars",
    )


def check_round(module, plan: WirePlan, i: int, sends: Dict[int, list],
                recvs: Dict[int, int]):
    """Verify round ``i`` of a replay against its frozen structure;
    returns ``(round, sends as host arrays)``. A mismatch is the loud
    typed divergence error — frames from a wrong header would corrupt
    the peer's reassembly."""
    if i >= len(plan.rounds):
        raise _mismatch(module, i, "more rounds than the plan recorded")
    rnd = plan.rounds[i]
    sends_f = {p: [_as_nd(a) for a in arrs]
               for p, arrs in sends.items() if arrs}
    meta = tuple(
        (p, tuple((a.shape, str(a.dtype)) for a in sends_f[p]))
        for p in sorted(sends_f))
    recvs_l = {int(p): int(c) for p, c in recvs.items() if int(c) > 0}
    if meta != rnd.sends_meta or recvs_l != rnd.recvs:
        raise _mismatch(module, i,
                        f"sends/recvs {meta}/{recvs_l} != frozen "
                        f"{rnd.sends_meta}/{rnd.recvs}")
    return rnd, sends_f


class PlannedXchg:
    """Exchange adapter replaying a frozen :class:`WirePlan`: each
    round verifies its structure against the plan (cheap tuple
    compare), then sends through the precomposed frame path and reaps
    in arrival order."""

    __slots__ = ("m", "plan", "i", "ts")

    def __init__(self, module, plan: WirePlan) -> None:
        self.m = module
        self.plan = plan
        self.i = 0
        #: round-end clock reads for the flight recorder (one
        #: perf_counter per planned round); None = unobserved fire,
        #: zero clock reads
        self.ts: Optional[List[float]] = None

    def exchange(self, sends: Dict[int, list],
                 recvs: Dict[int, int]) -> Dict[int, list]:
        # the whole replay round is Python orchestration (posting,
        # striping, reap polling) — self-report it so the steady-state
        # orchestration split sees the replay loop the native executor
        # exists to eliminate
        t0 = _time.perf_counter()
        try:
            return self._exchange(sends, recvs)
        finally:
            _driver._orch.add(_time.perf_counter() - t0)

    def _exchange(self, sends: Dict[int, list],
                  recvs: Dict[int, int]) -> Dict[int, list]:
        rnd, sends_f = check_round(self.m, self.plan, self.i, sends,
                                   recvs)
        self.i += 1
        m = self.m
        if sends_f:
            m._send_all_planned(rnd, sends_f)
        got: Dict[int, list] = {p: [] for p in rnd.recvs}
        if rnd.recvs:
            # record=False: the flight recorder owns this fire's
            # span/flow story (expanded from the plan structure at
            # doctor time) — per-arrival journal spans here would
            # duplicate the synthetic ones and advance the hier
            # flow-k counters the expansion re-derives from zero
            m._reap(dict(rnd.recvs),
                    lambda src, arr: got[src].append(arr),
                    self.plan.timeout_ms, record=False)
        ts = self.ts
        if ts is not None:
            ts.append(_time.perf_counter())
        return got


class SpanningPlanState:
    """Per-(cid, signature) frozen-wire-plan holder: first fire
    records and freezes, later fires replay; a registry write
    generation bump quietly re-records (cvar writes take effect at
    the next plan, never mid-schedule); a replay that fails drops the
    plan and its native executor."""

    __slots__ = ("comm", "name", "plan", "sig", "native", "last", "why",
                 "sentinel_tpl")

    def __init__(self, comm, name: str, sig: Optional[Tuple] = None
                 ) -> None:
        self.comm = comm
        self.name = name
        self.plan: Optional[WirePlan] = None
        #: the plan lowered into the C executor (coll/native_exec) —
        #: None when ineligible; lives and dies with ``plan``
        self.native = None
        self.sig = sig
        #: which executor ran the last fire: "interpreted" (recording,
        #: or plans off), "planned" (PlannedXchg) or "native"
        self.last: Optional[str] = None
        #: why the plan stayed on PlannedXchg (the native compile's
        #: _Ineligible/_ProbeFail text), None when it went native
        self.why: Optional[str] = None
        #: (key, InlineFrameTemplate) cache — sentinel level 2's
        #: precomposed ctl-frame payload for this plan's call shape
        self.sentinel_tpl: Optional[Tuple] = None

    def _drop_native(self) -> None:
        nx, self.native = self.native, None
        if nx is not None:
            nx.close()

    def run(self, fn: Callable, args: Tuple,
            kw: Optional[Dict]) -> Any:
        kw = kw or {}
        m = getattr(self.comm, "_hier_module", None)
        if m is None or not _enabled() or not _overlap_on():
            self.last = "interpreted"
            return fn(*args, **kw)
        gen = mca_var.VARS.generation
        plan = self.plan
        if plan is not None and plan.gen != gen:
            plan = self.plan = None  # cvars moved: re-plan
            self._drop_native()
        old = m._xchg
        if plan is None:
            # recording rides the fully-interpreted transport (spans,
            # flow ids, pvars untouched) — the recorder only watches
            t0 = _time.perf_counter()
            rec = RoundRecorder(old)
            m._xchg = rec
            try:
                out = fn(*args, **kw)
            finally:
                m._xchg = old
            self.last = "interpreted"
            self.plan = freeze_wire_plan(self.comm, rec.rounds, gen,
                                         rec.recv_metas)
            if self.plan is not None:
                _compiled_hits.observe(0)
                if _obs.enabled:
                    _obs.record("plan_freeze_" + self.name, "plan",
                                t0, _time.perf_counter() - t0,
                                comm_id=self.comm.cid)
                # lower the fresh plan into the C executor (two
                # wire-free probe runs + descriptor compile + ring
                # bind); None = ineligible, replay stays interpreted
                from . import native_exec as _native

                self.native = _native.try_compile(self, m, fn, args, kw)
            return out
        rec = _obs.enabled
        nx = self.native
        if nx is not None and nx.gen == plan.gen:
            from . import native_exec as _native

            px = _native.NativeXchg(m, plan, nx, args)
        else:
            px = PlannedXchg(m, plan)
        t0 = 0.0
        if rec:
            if plan.ledger_id is None:
                plan.ledger_id = _ledger.register_spanning_plan(
                    self.comm.cid, self.name, m.my_pidx, plan.rounds,
                    self.sig)
            px.ts = []
            _active_replays[id(self)] = (self, px)
            t0 = _time.perf_counter()
        m._xchg = px
        try:
            out = fn(*args, **kw)
        except BaseException:
            # ANY replay failure — structure divergence, a timeout
            # mid-round — drops the frozen plan so the next fire
            # re-records instead of replaying the same stale rounds
            self.plan = None
            self._drop_native()
            raise
        finally:
            m._xchg = old
            if rec:
                _active_replays.pop(id(self), None)
        self.last = "native" if getattr(px, "fired", False) \
            else "planned"
        _compiled_hits.observe(1)
        if rec and _obs.enabled:
            # one fixed-size binary record; round0 is the hier round
            # counter _wrap advanced for this fire (synchronized
            # across ranks under obs), the flow-id base the doctor's
            # expansion shares with the interpreted path
            _ledger.record_fire(_ledger.KIND_SPANNING, plan.ledger_id,
                                self.comm.cid, t0,
                                _time.perf_counter(),
                                round0=m._round, round_ts=px.ts)
        return out


def spanning_state_for(comm, name: str, args: Tuple,
                       kw: Optional[Dict]) -> Optional[SpanningPlanState]:
    """The comm's plan state for this call signature (None = not
    plannable: ragged buffers, non-deterministic families)."""
    if name not in _PLANNABLE:
        return None
    sig = signature_of(name, args, kw)
    if sig is None:
        return None
    key = (comm.cid, sig)
    st = _span_states.get(key)
    if st is None:
        with _lock:
            st = _span_states.setdefault(
                key, SpanningPlanState(comm, name, sig))
    return st


def spanning_wrap(state: Optional[SpanningPlanState],
                  fn: Callable) -> Callable:
    """Wrap one schedule body so its execution (on whichever thread
    the progress engine runs it) records/replays through ``state``."""
    if state is None:
        return fn
    return lambda *a, **k: state.run(fn, a, k)
