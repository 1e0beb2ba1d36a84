"""Host-side collective driver: the rank-axis runner.

Counterpart of ``ompi_release_tpu/coll/driver.py::run_sharded``. There a
per-rank body runs under ``shard_map`` as one compiled program per
(comm, operation, algorithm); here the body is a function over the whole
rank-stacked ``(size, ...)`` tensor (``coll/spmd.py``), run eagerly on
the comm's device. What stays from the reference:

- the buffer checks: a single tensor with leading axis == comm size
  (``ERR_COUNT`` otherwise), pair-op ``(values, indices)`` tuples only
  through ``extra_arrays`` (``ERR_TYPE`` otherwise);
- the per-comm program cache keyed by ``(component, family, alg, Op
  object[, seg])``: it caches the body callable; ``coll/plan.py``
  freezes a steady-state body, on the card as a CUDA graph;
- the ``coll_invocations`` / ``coll_programs_compiled`` /
  ``coll_plan_cache_hits`` pvars and the ``coll_orchestration_seconds``
  timer (Python time from the dispatch entry to the body's launch);
- the capture hooks ``coll/plan.py`` arms around a collective's first
  run (:func:`begin_capture`): each runner records (body, input
  tensor, output tensor) while a capture is armed;
- :func:`run_sharded2d`, the same runner over the ``(node, local)``
  factorization the hierarchical ``ml`` bodies use;
- the observability plane's skew timer (``obs/skew.py``): with obs on,
  each run marks arrival, the body's launch and its return, one
  ``coll``-layer span and the ``coll_<op>_*`` pvars. The span times the
  dispatch, not the card: nothing here synchronizes.
"""

from __future__ import annotations

import threading
import time as _time
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from .. import obs as _obs
from ..mca import pvar
from ..obs import skew as _skew
from ..utils.errors import ErrorCode, MPIError

_invoke_count = pvar.counter(
    "coll_invocations", "host-driver collective invocations"
)
_compile_count = pvar.counter(
    "coll_programs_compiled", "distinct cached collective programs"
)
# per-invocation plan-cache outcome: observe(1) on a cache hit,
# observe(0) on a miss — so sum/count IS the hit ratio
_plan_cache = pvar.aggregate(
    "coll_plan_cache_hits",
    "plan-cache outcome per driver invocation (1=hit, 0=miss); "
    "sum/count = hit ratio",
)
#: Python time on the collective DISPATCH path: from the collective's
#: dispatch entry to the moment the body (or a frozen plan) launches —
#: decision logic, cache lookups, validation. The delta across a run
#: isolates orchestration from device time.
_orch = pvar.timer(
    "coll_orchestration_seconds",
    "Python orchestration seconds on the collective dispatch path "
    "(decision, planning, validation, posting — before the compiled "
    "program or wire transport takes over)",
)

#: capture/attribution state for ``coll/plan.py``: ``entries`` records
#: each body launch (body, input tensor, output tensor) while a capture
#: is armed; ``t0`` re-bases the orchestration timer at the OUTER
#: dispatch entry so interpreted and frozen fires time the same span.
_capture_tls = threading.local()


def begin_capture() -> list:
    """Arm body-launch capture on this thread; returns the live entry
    list (one dict per runner launch)."""
    entries: list = []
    _capture_tls.entries = entries
    return entries


def end_capture() -> None:
    _capture_tls.entries = None


def orch_mark(t0: float) -> None:
    """Re-base the next runner's orchestration interval at ``t0`` (the
    outer dispatch entry), so the timer covers the decision path too."""
    _capture_tls.t0 = t0


def orch_clear() -> None:
    _capture_tls.t0 = None


def _orch_t0(default: float) -> float:
    t0 = getattr(_capture_tls, "t0", None)
    if t0 is None:
        return default
    _capture_tls.t0 = None  # one-shot: consumed by this launch
    return t0


def _op_name(key: Tuple) -> str:
    """Collective-op label from a program-cache key — keys are
    (component, op, ...) tuples by convention throughout coll/."""
    if isinstance(key, tuple) and len(key) > 1 and isinstance(key[1], str):
        return key[1]
    return str(key[0]) if isinstance(key, tuple) and key else str(key)


def _launch(body: Callable, x: torch.Tensor, extras: Tuple,
            t_in: float, tok=None) -> Any:
    """Run the cached body, recording it while a capture is armed: the
    input and output OBJECTS let ``coll/plan.py`` prove the collective
    was the body alone (no pre- or post-processing around it)."""
    cap = getattr(_capture_tls, "entries", None)
    if cap is not None:
        cap.append({"prog": body, "x": x, "extra": bool(extras),
                    "out": None})
    _orch.add(_time.perf_counter() - t_in)
    if tok is None:
        out = body(x, *extras)
    else:
        # skew emit point: wait = arrival -> body launch (cache lookup,
        # validation), body = the dispatch itself
        _skew.body(tok)
        out = body(x, *extras)
        _skew.end(tok, int(x.numel()) * int(x.element_size()))
    if cap is not None:
        cap[-1]["out"] = out
    return out


def as_rank_buffer(x, device: torch.device) -> torch.Tensor:
    """A rank-stacked buffer as a tensor on ``device``: tensors move,
    numpy arrays (bfloat16 ones included) are copied over."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, np.ndarray) or np.isscalar(x) or isinstance(x, list):
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":  # ml_dtypes: no torch from_numpy
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
            return t.view(torch.bfloat16).to(device)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return x  # anything else is the driver's to reject


def _program_cache(comm) -> Dict[Tuple, Callable]:
    cache = getattr(comm, "_coll_programs", None)
    if cache is None:
        cache = {}
        comm._coll_programs = cache
    return cache


def run_sharded(comm, key: Tuple, body: Callable, x, *,
                extra_arrays: Tuple = ()) -> Any:
    """Run ``body(x, *extra_arrays)`` over the comm's rank-stacked
    buffers (leading axis == comm.size, every extra array laid out the
    same way). The body for ``key`` is cached on the communicator: the
    key must hold every static parameter the body closes over."""
    t_in = _orch_t0(_time.perf_counter())
    _invoke_count.add()
    tok = (_skew.begin(_op_name(key), getattr(comm, "cid", -1))
           if _obs.enabled else None)
    if not isinstance(x, torch.Tensor):
        raise MPIError(
            ErrorCode.ERR_TYPE,
            "driver-mode collectives take a single tensor with a leading "
            "rank axis; pair-op (value, index) tuples are supported by "
            "allreduce/reduce (MINLOC/MAXLOC)",
        )
    for arr in (x,) + tuple(extra_arrays):
        if arr.shape[0] != comm.size:
            raise MPIError(
                ErrorCode.ERR_COUNT,
                f"driver-mode buffer leading axis {arr.shape[0]} != comm "
                f"size {comm.size} (one slice per rank)",
            )
    cache = _program_cache(comm)
    prog = cache.get(key)
    _plan_cache.observe(0.0 if prog is None else 1.0)
    if prog is None:
        _compile_count.add()
        prog = body
        cache[key] = prog
    return _launch(prog, x.to(comm.device),
                   tuple(e.to(comm.device) for e in extra_arrays), t_in,
                   tok)


def run_sharded2d(comm, key: Tuple, body: Callable, x, *,
                  inter: int, intra: int) -> Any:
    """Like :func:`run_sharded` over a 2-D (node, local) factorization
    of the comm's ranks: rank r = (node r // intra, local r % intra),
    the sbgp subgrouping the hierarchical (``ml``) bodies close over.
    ``ERR_COUNT`` unless the leading axis is the comm size and
    inter * intra == size; the program cache and the pvars are
    :func:`run_sharded`'s."""
    t_in = _orch_t0(_time.perf_counter())
    _invoke_count.add()
    tok = (_skew.begin(_op_name(key), getattr(comm, "cid", -1))
           if _obs.enabled else None)
    if not isinstance(x, torch.Tensor):
        raise MPIError(ErrorCode.ERR_TYPE,
                       "driver-mode collectives take a single tensor with "
                       "a leading rank axis")
    if x.shape[0] != comm.size or inter * intra != comm.size:
        raise MPIError(
            ErrorCode.ERR_COUNT,
            f"2-D driver needs leading axis == size ({comm.size}) and "
            f"inter*intra == size (got {inter}x{intra})",
        )
    cache = _program_cache(comm)
    prog = cache.get(key)
    _plan_cache.observe(0.0 if prog is None else 1.0)
    if prog is None:
        _compile_count.add()
        prog = body
        cache[key] = prog
    return _launch(prog, x.to(comm.device), (), t_in, tok)
