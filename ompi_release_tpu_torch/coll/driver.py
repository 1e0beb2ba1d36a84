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
  object[, seg])``: it caches the body callable (capturing it as a CUDA
  graph is later work);
- the ``coll_invocations`` / ``coll_programs_compiled`` /
  ``coll_plan_cache_hits`` pvars.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from ..mca import pvar
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
    _invoke_count.add()
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
    return prog(x.to(comm.device), *[e.to(comm.device) for e in extra_arrays])
