"""Pipeline parallelism with one stage: ``pipeline`` of
``ompi_release_tpu/parallel/pp.py:37-94`` at pp = 1.

With one stage the GPipe schedule's M + S - 1 ticks are the M
microbatches in order through the one stage, and nothing crosses a
stage boundary. ``HostPipeline`` (stages in separate processes) waits
for the multi-process slice.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint


def pipeline(stage_fn: Callable, stage_params, x_microbatches: torch.Tensor,
             *, remat: bool = False) -> torch.Tensor:
    """``stage_fn(params, x)`` over the M microbatches of
    ``x_microbatches`` (M, ...), in order; returns (M, ...).

    ``remat=True`` wraps the stage in ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint``, ``pp.py:57-62``): the backward
    recomputes each microbatch's activations instead of keeping them
    live. The gradients are the same arithmetic."""
    if remat:
        fn = stage_fn

        def stage_fn(params, x):
            return checkpoint(fn, params, x, use_reentrant=False)

    return torch.stack([stage_fn(stage_params, x_microbatches[t])
                        for t in range(x_microbatches.shape[0])])
