"""Tracing interposition — the PMPI / libompitrace analogue.

The reference lets tracers interpose on every MPI call without
relinking via weak PMPI symbols (``ompi/mpi/c/init.c:32``) and ships
``libompitrace`` as a minimal example. The same property here: wrap a
communicator in :func:`wrap` and every collective/p2p call is recorded
(name, wall time, payload bytes) to an event list, optional JSONL
sink, and per-operation timing pvars — without touching the wrapped
object or the call sites. ``profiler_trace`` bridges to
``torch.profiler`` for device-side timelines: its Chrome trace holds
the port's ``mpi.<layer>.<op>`` ranges (``obs/spans.py``) beside the
CUDA kernels and copies they launched.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Callable, Dict, List, Optional

from .. import obs as _obs
from ..mca import pvar

#: communicator methods interposed (the PMPI surface built so far)
TRACED = (
    "allreduce", "reduce", "bcast", "allgather", "gather", "scatter",
    "reduce_scatter_block", "alltoall", "scan", "exscan", "barrier",
    "iallreduce", "ireduce", "ibcast", "iallgather", "igather",
    "iscatter", "ireduce_scatter_block", "ireduce_scatter",
    "ialltoall", "iscan", "iexscan", "ibarrier",
    "allreduce_init", "bcast_init", "allgather_init",
    "reduce_scatter_init", "alltoall_init", "barrier_init",
    "send", "recv", "isend", "irecv", "sendrecv", "iprobe",
)


class TraceEvent:
    __slots__ = ("op", "t_start", "dt", "nbytes")

    def __init__(self, op: str, t_start: float, dt: float,
                 nbytes: int) -> None:
        self.op = op
        self.t_start = t_start
        self.dt = dt
        self.nbytes = nbytes

    def asdict(self) -> Dict[str, Any]:
        return {"op": self.op, "t": self.t_start, "dt": self.dt,
                "bytes": self.nbytes}


def _payload_bytes(args, kwargs: Optional[Dict[str, Any]] = None) -> int:
    """Total bytes across positional AND keyword array arguments —
    calls made with keyword buffers (``comm.allreduce(x=buf)``) must
    count the same as positional ones."""
    n = 0
    vals = list(args) + (list(kwargs.values()) if kwargs else [])
    for a in vals:
        sz = getattr(a, "size", None)
        it = getattr(getattr(a, "dtype", None), "itemsize", None)
        if sz is not None and it is not None:
            n += int(sz) * int(it)
    return n


class TracingComm:
    """Transparent proxy: traced methods are timed + recorded, all
    other attribute access passes through."""

    def __init__(self, comm, sink_path: Optional[str] = None) -> None:
        object.__setattr__(self, "_comm", comm)
        object.__setattr__(self, "events", [])
        object.__setattr__(self, "_sink", open(sink_path, "a")
                           if sink_path else None)
        object.__setattr__(self, "_timers", {})

    def _timer(self, op: str):
        t = self._timers.get(op)
        if t is None:
            t = pvar.timer(f"trace_{op}_seconds",
                           f"cumulative time in traced {op}")
            self._timers[op] = t
        return t

    def __getattr__(self, name: str) -> Any:
        attr = getattr(self._comm, name)
        if name not in TRACED or not callable(attr):
            return attr

        def traced(*args, **kw):
            t0 = time.perf_counter()
            try:
                return attr(*args, **kw)
            finally:
                dt = time.perf_counter() - t0
                ev = TraceEvent(name, t0, dt, _payload_bytes(args, kw))
                self.events.append(ev)
                self._timer(name).add(dt)
                if _obs.enabled:
                    # the PMPI proxy feeds the same journal as the
                    # in-framework emit points: one stream
                    _obs.record(name, "pmpi", t0, dt, nbytes=ev.nbytes)
                if self._sink is not None:
                    self._sink.write(json.dumps(ev.asdict()) + "\n")
                    # flush per event: a crashed run must not lose
                    # buffered trace lines
                    self._sink.flush()

        return traced

    def __setattr__(self, name: str, value: Any) -> None:
        setattr(self._comm, name, value)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for ev in self.events:
            s = out.setdefault(
                ev.op, {"calls": 0, "seconds": 0.0, "bytes": 0}
            )
            s["calls"] += 1
            s["seconds"] += ev.dt
            s["bytes"] += ev.nbytes
        return out

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()


def wrap(comm, sink_path: Optional[str] = None) -> TracingComm:
    """Interpose on a communicator (PMPI shim analogue)."""
    return TracingComm(comm, sink_path)


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """Device-side profiling via ``torch.profiler`` (a Chrome trace of
    host and CUDA activity written under ``logdir``), the VampirTrace
    analogue for the compiled data plane. While it collects, the port's
    layers emit their ``mpi.*`` ranges (``obs/spans.py``), each beside
    the device work it launched. The profiler stays on the CPU when no
    card is present."""
    import os

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace-{os.getpid()}.json"))
