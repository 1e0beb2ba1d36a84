"""The port's layers as named intervals: ``mpi.<layer>.<op>`` ranges on
the profiler's clock, and the device time under them as MPI_T pvars.

An emit site opens its spans only behind THE gate, and takes
:data:`OFF`, which does nothing, otherwise::

    with (_spans.span(...) if _obs.enabled or _tprof._is_profiler_enabled
          else _spans.OFF):

where ``_tprof`` is ``torch.autograd.profiler``, whose module bool torch
sets while a profiler (``torch.profiler.profile``, the port's
``tools/trace.profiler_trace``) collects. Off, a site costs those two
attribute reads: no clock read, no allocation, no CUDA call. On, each
step of a site (:meth:`Steps.step`; :func:`span` is a site of one step):

- while a profiler collects, is a range named ``mpi.<layer>.<op>``
  (torch's ``RecordFunctionFast``: the ``record_function`` machinery
  without the Python wrapper that costs several times more): a host
  event on the profiler's own clock, nested in the ranges of the layers
  above it, beside the device operations it launched;
- with a ``host`` (a TIMER pvar), adds its host seconds to it, and with
  a ``count`` (a COUNTER pvar), ``n`` (the bytes it moves, say);
- with obs on and a ``timer`` (a :class:`~..mca.pvar.DeviceTimer`), is
  an interval of a :class:`~..mca.pvar.EventChain` on the device's
  current stream: a site's consecutive steps share the CUDA event at
  each boundary, so a fire of three steps records four events.

Under a profiler alone no CUDA event is recorded: the profiler's own
device trace already times the kernels under each range, and a fire's
four event records sit on the host's path to the card (each ~5 us with
CUPTI attached), which shows as idle wherever the host sets the pace. Nor
is one recorded while the current stream captures a CUDA graph: the
events would become nodes of the graph and time the capture.

The journal keeps the spans it had: a site that journaled its interval
with obs on still does, gated as before, and passes the range's name to
``obs.record``; an interval that ``obs/skew.py`` or the obs ledger
already records gets no second journal entry.
"""

from __future__ import annotations

import time

import torch
from torch.autograd import profiler as _tprof

from .. import obs as _obs
from ..mca import pvar as _pvar

#: the profiler range a step opens
_Range = torch._C._profiler._RecordFunctionFast


def _capturing() -> bool:
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


class Steps:
    """A site's consecutive steps (a context manager that ends the last
    one; see the module docstring). Obs off, ``device`` None or not a
    card, or a capture on its stream: no CUDA event."""

    __slots__ = ("_chain", "_range", "_host", "_t0")

    def __init__(self, device=None) -> None:
        self._range = self._host = None
        self._chain = (_pvar.EventChain(device)
                       if _obs.enabled and device is not None
                       and device.type == "cuda" and not _capturing()
                       else None)

    def step(self, layer: str, op: str, timer=None, host=None, count=None,
             n: int = 0) -> None:
        """End the step running and start ``mpi.<layer>.<op>``."""
        self._end_step()
        if _tprof._is_profiler_enabled:
            self._range = _Range(f"mpi.{layer}.{op}")
            self._range.__enter__()
        if self._chain is not None:
            self._chain.mark(timer)
        if count is not None:
            count.add(n)
        if host is not None:
            self._host = host
            self._t0 = time.perf_counter()

    def _end_step(self) -> None:
        if self._host is not None:
            self._host.add(time.perf_counter() - self._t0)
            self._host = None
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    def __enter__(self) -> "Steps":
        return self

    def __exit__(self, *exc) -> bool:
        self._end_step()
        if self._chain is not None:
            self._chain.close()
        return False


def span(layer: str, op: str, *, device=None, timer=None) -> Steps:
    """A site of one step, started: ``with span(...):``."""
    st = Steps(device if timer is not None else None)
    st.step(layer, op, timer)
    return st


class _Off:
    """What a site takes with the gate off: nothing at all."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def step(self, layer, op, timer=None, host=None, count=None,
             n=0) -> None:
        pass


OFF = _Off()
