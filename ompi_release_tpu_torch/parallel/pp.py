"""Pipeline parallelism: the GPipe microbatch schedule over a ppermute
ring, and the host-driven schedule over a communicator.

Counterpart of ``ompi_release_tpu/parallel/pp.py``. :func:`pipeline`
runs M microbatches through S stages in M + S - 1 ticks: on every tick
every stage computes (one call of ``stage_fn``, batched over the stacked
pp ranks, each slice with its own stage's parameters), stage 0 reads
microbatch t and the others what the ring delivered, and the activation
moves to stage + 1. The bubble is (S - 1)/(M + S - 1). With one stage
the ticks are the microbatches in order. :class:`HostPipeline` runs the
same wavefront with each stage a rank of a communicator, boundary
activations as messages.
"""

from __future__ import annotations

import time as _time
from typing import Any, Callable, List, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from ..mca import pvar
from . import axes

_boundary_msgs = pvar.counter(
    "pp_boundary_msgs", "host-pipeline stage-boundary activations sent"
)
_boundary_wait = pvar.timer(
    "pp_boundary_wait_seconds",
    "EXPOSED host-pipeline boundary-transfer time (recv wait the "
    "stage could not hide in its microbatch compute)",
)


def pipeline(stage_fn: Callable, stage_params, x_microbatches: torch.Tensor,
             *, axis_name: str = "pp", remat: bool = False) -> torch.Tensor:
    """Run microbatches through the stage pipeline.

    ``stage_fn(params, x) -> y`` with y shaped as x; ``x_microbatches``
    (M, ...) per rank, read on stage 0. Returns (M, ...), meaningful on
    the last stage (zeros on the others).

    ``remat=True`` wraps the stage in ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint``): the backward recomputes each tick's
    activations instead of keeping them live. The gradients are the same
    arithmetic."""
    if remat:
        fn, mesh = stage_fn, axes.current_mesh()

        def bound(params, x):
            # the backward's recompute runs outside the caller's mesh
            if mesh is None:
                return fn(params, x)
            with mesh:
                return fn(params, x)

        def stage_fn(params, x):
            return checkpoint(bound, params, x, use_reentrant=False)

    n = axes.axis_size_or_1(axis_name)
    lead = axes.lead(x_microbatches)
    m = x_microbatches.shape[lead]
    if n == 1:
        return torch.stack([stage_fn(stage_params,
                                     x_microbatches.select(lead, t))
                            for t in range(m)], dim=lead)
    per_mb = x_microbatches.dim() - lead - 1
    stage = axes.axis_index(axis_name, per_mb)
    fwd = [(i, i + 1) for i in range(n - 1)]
    zero = torch.zeros((), dtype=x_microbatches.dtype,
                       device=x_microbatches.device)
    recv = zero
    outputs: List[torch.Tensor] = []
    for t in range(m + n - 1):
        mb = x_microbatches.select(lead, min(t, m - 1))
        out = stage_fn(stage_params, torch.where(stage == 0, mb, recv))
        if t >= n - 1:  # the last stage holds microbatch t - (n - 1)
            outputs.append(torch.where(stage == n - 1, out, zero))
        if t < m + n - 2:
            recv = axes.ppermute(out, axis_name, fwd)
    return torch.stack(outputs, dim=lead)


def pipeline_loss(stage_fn: Callable, loss_fn: Callable, stage_params,
                  x_microbatches: torch.Tensor, target_microbatches, *,
                  axis_name: str = "pp", remat: bool = False) -> torch.Tensor:
    """Forward pipeline + last-stage loss, the same value on every stage.

    ``loss_fn(y, targets) -> per-rank scalar`` runs on the last stage's
    outputs. As in the reference the value every stage returns is
    ``masked + stop_gradient(psum(masked) - masked)``: only the last
    stage's own term carries a gradient, so differentiating the SUM of
    the stages' copies (what ``jax.grad`` of a per-rank loss inside
    shard_map does) gives each stage its true gradient, once, and
    differentiating any single copy gives the last stage's share."""
    n = axes.axis_size_or_1(axis_name)
    y = pipeline(stage_fn, stage_params, x_microbatches,
                 axis_name=axis_name, remat=remat)
    local = loss_fn(y, target_microbatches)
    if n == 1:
        return local
    stage = axes.axis_index(axis_name, local.dim() - axes.lead(local))
    masked = torch.where(stage == n - 1, local, torch.zeros_like(local))
    bcast = axes.psum(masked, axis_name)
    return masked + (bcast - masked).detach()


# ---------------------------------------------------------------------------
# host-driver microbatch schedule (nonblocking boundaries)
# ---------------------------------------------------------------------------

class HostPipeline:
    """GPipe microbatch schedule driven from the host over a
    communicator: each member rank is one stage, boundary activations
    ride rank-to-rank messages instead of a ring inside one program.

    With ``nonblocking=True`` (default) every boundary ``irecv`` is
    posted up front and every ``isend`` is waited only at the schedule's
    end, so the transfers overlap the stage's next microbatches (the
    exposed remainder is the ``pp_boundary_wait_seconds`` pvar).
    ``nonblocking=False`` is the blocking leg: each boundary send and
    recv runs between two computes. The results are identical between
    the two legs (the same ``stage_fn`` calls in the same order; the
    transfers move data only). One controller runs the stages it plays
    one after another in stage order (driver mode: the acting rank is
    explicit), so a boundary to a stage of the same controller is handed
    over by a standard send, whatever its size: it returns at once (an
    eager copy, or a snapshot awaiting the receive), where an ``isend``
    above ``pml_eager_limit`` would wait for a receive that cannot post
    before this stage ends. Under tpurun each process runs its local
    ranks' stages and the boundaries between processes ride the wire
    PML's nonblocking sends."""

    def __init__(self, comm, stage_fn: Callable, *,
                 stage: Optional[int] = None, tag: int = 71,
                 nonblocking: bool = True) -> None:
        self.comm = comm
        self.stage_fn = stage_fn
        if stage is None:
            ranks = getattr(comm, "local_comm_ranks", None)
            stage = ranks[0] if ranks else 0
        self.stage = int(stage)
        self.tag = tag
        self.nonblocking = nonblocking

    def run(self, microbatches: Sequence[Any]) -> List[Any]:
        """Stream ``microbatches`` through this stage. Stage 0 consumes
        the inputs; the last stage returns the list of outputs (the
        other stages return [])."""
        comm, s, tag = self.comm, self.stage, self.tag
        n_stages = comm.size
        m = len(microbatches)
        nb = self.nonblocking
        played = set(getattr(comm, "local_comm_ranks", range(n_stages)))
        recvs: List[Any] = []
        if s > 0 and nb:
            # every boundary irecv posts before the first compute
            recvs = [comm.irecv(s - 1, tag, rank=s) for _ in range(m)]
        outs: List[Any] = []
        sends: List[Any] = []
        for k in range(m):
            if s == 0:
                x = microbatches[k]
            else:
                t0 = _time.perf_counter()
                if nb:
                    req = recvs[k]
                    req.wait()
                    x = req.value
                else:
                    x, _st = comm.recv(s - 1, tag, rank=s)
                _boundary_wait.add(_time.perf_counter() - t0)
            y = self.stage_fn(x)
            if s < n_stages - 1:
                _boundary_msgs.add()
                if nb and s + 1 not in played:
                    # fire and keep computing; drained at schedule end
                    sends.append(comm.isend(y, s + 1, tag, rank=s))
                else:
                    comm.send(y, s + 1, tag, rank=s)
            else:
                outs.append(y)
        for req in sends:
            req.wait()
        return outs
