"""Pipelined segmented collectives of the tuned component.

Counterpart of ``ompi_release_tpu/coll/pipeline.py``. Messages above the
``coll_pipeline_segsize`` cvar (or a dynamic rule's ``segsize`` column)
split into K segments. The reference unrolls the segments into one
compiled program, double-buffered with ``optimization_barrier``; the
port runs them one after another on the device's stream, so the working
set of each ring step is one segment's chunks.

Bitwise parity with the monolithic algorithms is the design invariant:

- ring allreduce segments WITHIN ring-chunk rows: the buffer is chunked
  exactly like the monolithic ring, then each row splits into column
  segments, so every element keeps its chunk index — and a ring
  element's accumulation order is a function of its chunk index alone;
- binomial bcast/reduce segment the flat buffer: the tree schedule never
  depends on an element's position.

The per-comm program cache key gains ``("pipelined", nseg)``.
"""

from __future__ import annotations

import time
from typing import Callable, List, Tuple

import torch

from .. import obs as _obs
from ..mca import pvar
from ..mca import var as mca_var
from ..ops.op import Op
from . import driver as _driver
from . import dynamic_rules, spmd

#: the tuned algorithm of each collective that runs segmented (what a
#: rule's segsize column, and tpu-tune's segsize sweep, applies to)
PIPELINE_CAPABLE = {
    "allreduce": "ring",
    "bcast": "binomial",
    "reduce": "binomial",
}

_segments = pvar.aggregate(
    "coll_pipeline_segments",
    "segments per pipelined collective dispatch (count = pipelined "
    "calls, sum/max = segment counts in effect)",
)


def register_vars() -> None:
    mca_var.register(
        "coll_pipeline_segsize", "size", 1 << 20,
        "Per-rank bytes per pipeline segment: messages above this split "
        "into segments run in order (coll_tuned_<op>_segmentsize "
        "analogue); 0 disables pipelining; a dynamic rule's segsize "
        "column overrides this",
    )
    mca_var.register(
        "coll_pipeline_max_segments", "int", 64,
        "Upper bound on segments per pipelined collective",
    )


register_vars()  # idempotent; cvars must exist before first dispatch


def pick_segsize(coll: str, comm_size: int, msg_bytes: int) -> int:
    """Segment bytes for this call: the rule file's ``segsize`` when one
    matches, else ``coll_pipeline_segsize``. 0 = pipelining off."""
    seg = dynamic_rules.lookup_segsize(coll, comm_size, msg_bytes)
    if seg is None:
        seg = int(mca_var.get("coll_pipeline_segsize", 1 << 20))
    return seg


def segment_count(coll: str, comm_size: int, msg_bytes: int) -> int:
    """How many segments this message splits into (1 = monolithic)."""
    seg = pick_segsize(coll, comm_size, msg_bytes)
    if seg <= 0 or msg_bytes <= seg:
        return 1
    cap = max(1, int(mca_var.get("coll_pipeline_max_segments", 64)))
    return min(-(-msg_bytes // seg), cap)


def allreduce_ring_pipelined(x: torch.Tensor, op: Op, n: int,
                             nseg: int) -> torch.Tensor:
    """Ring allreduce over ``nseg`` column segments of the ring-chunk
    matrix; bitwise-identical to :func:`spmd.allreduce_ring`."""
    if n == 1:
        return x.clone()
    if nseg <= 1 or spmd.ring_on_kernel(x, op):
        return spmd.allreduce_ring(x, op, n)  # the kernel: the same bits
    flat = x.reshape(n, -1)
    total = flat.shape[1]
    chunk = -(-total // n)  # ceil — the monolithic ring's row assignment
    ident = op.identity_for(x.dtype)
    chunks = spmd._pad_to(flat, chunk * n, ident).reshape(n * n, chunk)
    seg = -(-chunk // nseg)
    chunks = spmd._pad_to(chunks, nseg * seg, ident).reshape(n, n, nseg * seg)
    outs: List[torch.Tensor] = []
    for s in range(nseg):
        blk = chunks[:, :, s * seg:(s + 1) * seg].contiguous()
        outs.append(spmd._ring_passes(blk, op, n))
    out = torch.cat(outs, dim=2)[:, :, :chunk]
    return out.reshape(n, -1)[:, :total].reshape(x.shape)


def _flat_segments(x: torch.Tensor, nseg: int) -> Tuple[List[torch.Tensor],
                                                        int]:
    """Split each rank's flat buffer into ``nseg`` equal segments (the
    last zero-padded); returns (segments, elements per rank)."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    total = flat.shape[1]
    seg = -(-total // nseg)
    padded = spmd._pad_to(flat, nseg * seg, 0).reshape(n, nseg, seg)
    return [padded[:, s].contiguous() for s in range(nseg)], total


def _join(outs: List[torch.Tensor], total: int, shape) -> torch.Tensor:
    return torch.cat(outs, dim=1)[:, :total].reshape(shape)


def bcast_binomial_pipelined(x: torch.Tensor, n: int, root: int,
                             nseg: int) -> torch.Tensor:
    """Binomial-tree bcast over flat segments (no reduction: any
    segmentation is trivially bitwise-equal)."""
    if n == 1 or nseg <= 1:
        return spmd.bcast_binomial(x, n, root)
    segs, total = _flat_segments(x, nseg)
    return _join([spmd.bcast_binomial(s, n, root) for s in segs], total,
                 x.shape)


def reduce_binomial_pipelined(x: torch.Tensor, op: Op, n: int, root: int,
                              nseg: int) -> torch.Tensor:
    """Binomial-tree reduce over flat segments; bitwise-identical to
    :func:`spmd.reduce_binomial` (non-root ranks keep partials — the
    caller applies the root mask)."""
    if n == 1 or nseg <= 1:
        return spmd.reduce_binomial(x, op, n, root)
    segs, total = _flat_segments(x, nseg)
    return _join([spmd.reduce_binomial(s, op, n, root) for s in segs],
                 total, x.shape)


def run_pipelined(comm, key: Tuple, body: Callable, x, *,
                  nseg: int, nbytes: int = 0,
                  opname: str = "") -> torch.Tensor:
    """Dispatch a pipelined body through the driver with the segment
    count appended to the program-cache key. With obs on, the run is
    one ``pipeline``-layer span named ``opname`` carrying ``nbytes``."""
    _segments.observe(nseg)  # zero-cost pvar site (module-level)
    full_key = key + ("pipelined", nseg)
    if not _obs.enabled:
        return _driver.run_sharded(comm, full_key, body, x)
    label = opname or _driver._op_name(key)
    t0 = time.perf_counter()
    out = _driver.run_sharded(comm, full_key, body, x)
    _obs.record(label, "pipeline", t0, time.perf_counter() - t0,
                nbytes=nbytes, comm_id=getattr(comm, "cid", -1))
    return out
