"""Sequence parallelism: Ulysses head <-> sequence resharding.

Counterpart of ``ompi_release_tpu/parallel/sp.py``. Attention needs the
full sequence per head, the rest of the model wants the sequence sharded;
one tiled ``all_to_all`` over sp flips between the two layouts
(``parallel/axes.py``: a transpose of the sp rank dim with the split
block dim).
"""

from __future__ import annotations

from typing import Callable

import torch

from . import axes


def seq_to_heads(x: torch.Tensor, *, axis_name: str = "sp",
                 seq_axis: int = 0, head_axis: int = 1) -> torch.Tensor:
    """(S/n, H, ...) per rank -> (S, H/n, ...): gather the sequence,
    shard the heads. H must divide by the sp size."""
    return axes.all_to_all(x, axis_name, split_axis=head_axis,
                           concat_axis=seq_axis, tiled=True)


def heads_to_seq(x: torch.Tensor, *, axis_name: str = "sp",
                 seq_axis: int = 0, head_axis: int = 1) -> torch.Tensor:
    """The inverse reshard: (S, H/n, ...) -> (S/n, H, ...)."""
    return axes.all_to_all(x, axis_name, split_axis=seq_axis,
                           concat_axis=head_axis, tiled=True)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      attn_fn: Callable, *,
                      axis_name: str = "sp") -> torch.Tensor:
    """The Ulysses round trip: q/k/v (S/n, H, D) per rank resharded to
    head-sharded full sequences, ``attn_fn(q, k, v)`` (any local
    attention, (S, H/n, D) in and out) and the output resharded back."""
    qh, kh, vh = (seq_to_heads(t, axis_name=axis_name) for t in (q, k, v))
    return heads_to_seq(attn_fn(qh, kh, vh), axis_name=axis_name)
