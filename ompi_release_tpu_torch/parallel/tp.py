"""Tensor parallelism: Megatron-style sharded linear layers, embedding
and loss (counterpart of ``ompi_release_tpu/parallel/tp.py``).

A column-parallel matmul shards the output features (no communication;
its input is made varying over tp with ``axes.vary``, Megatron's ``f``:
the backward psums the input's cotangent), a row-parallel matmul shards
the input features and psums the partial products (``g``). Matmuls
accumulate in f32 and round once to the input dtype, as
``preferred_element_type=f32`` then ``astype`` does; the loss works on
f32 logits. Values follow ``parallel/mesh_axes.py``'s stacked layout
inside a mesh; outside one (or at tp = 1) every collective is the
identity and the functions are the one-shard math.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import axes


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # cuBLAS and the CPU kernels accumulate bf16 products in f32 and round
    # the output once: preferred_element_type=f32 followed by astype
    return axes.rank_matmul(x, w)


def column_parallel(x: torch.Tensor, w_shard: torch.Tensor,
                    b_shard: Optional[torch.Tensor] = None, *,
                    axis_name: str = "tp",
                    gather_output: bool = False) -> torch.Tensor:
    """``y_shard = x @ w_shard (+ b_shard)``: x (..., D) replicated over
    tp, w_shard (D, F/n) this rank's output columns. With
    ``gather_output`` the full (..., F) is all_gathered."""
    y = _matmul(axes.vary(x, axis_name), w_shard).to(x.dtype)
    if b_shard is not None:
        y = y + axes.align(b_shard, y.dim() - axes.lead(y))
    if gather_output:
        y = axes.all_gather(y, axis_name, axis=-1, tiled=True)
    return y


def row_parallel(x_shard: torch.Tensor, w_shard: torch.Tensor,
                 b: Optional[torch.Tensor] = None, *, axis_name: str = "tp",
                 scatter_output: bool = False) -> torch.Tensor:
    """``y = psum_tp(x_shard @ w_shard) (+ b)``: x_shard (..., F/n), what
    column_parallel produced; w_shard (F/n, D) this rank's input rows.
    With ``scatter_output`` the psum is a reduce_scatter over the leading
    (sequence) dim instead."""
    part = _matmul(x_shard, w_shard).to(x_shard.dtype)
    if scatter_output:
        y = axes.psum_scatter(part, axis_name, scatter_dimension=0,
                              tiled=True)
    else:
        y = axes.psum(part, axis_name)
    if b is not None:
        y = y + axes.align(b, y.dim() - axes.lead(y))
    return y


def _shard_start(axis_name: str, vshard: int, ndim: int):
    return axes.axis_index(axis_name, ndim) * vshard


def vocab_parallel_embedding(ids: torch.Tensor, table_shard: torch.Tensor,
                             *, axis_name: str = "tp") -> torch.Tensor:
    """Embedding with the vocab dim sharded over tp: table_shard (V/n, D).
    Each rank looks up the ids in its vocab range (out-of-range ids give
    zero rows) and the psum assembles the full lookup."""
    vshard = table_shard.shape[-2]
    lead = axes.lead(table_shard)
    local = ids - _shard_start(axis_name, vshard, ids.dim() - lead)
    in_range = (local >= 0) & (local < vshard)
    idx = local.clamp(0, vshard - 1).long()
    if lead:
        rows = _rank_rows(table_shard, idx, lead)
    else:
        rows = table_shard[idx]
    rows = torch.where(in_range[..., None], rows, torch.zeros_like(rows))
    return axes.psum(rows, axis_name)


def _rank_rows(table: torch.Tensor, idx: torch.Tensor,
               lead: int) -> torch.Tensor:
    """Per rank ``table_r[idx_r]``: the ranks' tables flattened into one,
    each rank's ids offset to its own table (one embedding gather)."""
    tl = table.shape[:lead]
    flat = table.reshape(-1, table.shape[-1])
    off = torch.zeros((), dtype=torch.long, device=idx.device)
    stride = 1
    for d in reversed(range(lead)):
        if tl[d] > 1:
            shape = [1] * idx.dim()
            shape[d] = tl[d]
            off = off + torch.arange(tl[d], device=idx.device).view(
                shape) * stride
        stride *= tl[d]
    return torch.nn.functional.embedding(off * table.shape[-2] + idx, flat)


def vocab_parallel_logits(h: torch.Tensor, table_shard: torch.Tensor, *,
                          axis_name: str = "tp",
                          gather: bool = True) -> torch.Tensor:
    """Tied-embedding LM head: f32 logits over the sharded vocab (all
    gathered along the last dim unless ``gather`` is False)."""
    logits = _matmul(axes.vary(h, axis_name), table_shard.transpose(-1, -2))
    if gather:
        logits = axes.all_gather(logits, axis_name, axis=-1, tiled=True)
    return logits


def vocab_parallel_xent(h: torch.Tensor, table_shard: torch.Tensor,
                        targets: torch.Tensor, *,
                        axis_name: str = "tp") -> torch.Tensor:
    """Per-token ``-log p(target)`` over a vocab-sharded LM head without
    the full (..., V) logits: ``m + log(sum(exp(logits - m))) -
    logits[target]`` with the row max ``m`` (carrying no gradient), the
    sum-exp and the target logit each one pmax/psum over tp; h and the
    table f32. A target outside this rank's range contributes zero."""
    logits = _matmul(axes.vary(h, axis_name), table_shard.transpose(-1, -2))
    # the max shift is for numerical stability only: no gradient flows
    # through it (the reference's _pmax_nograd, tp.py:22-33)
    m = axes.pmax_nograd(logits.amax(dim=-1), axis_name)
    se = axes.psum(torch.exp(logits - m[..., None]).sum(dim=-1), axis_name)
    vshard = table_shard.shape[-2]
    local = targets - _shard_start(axis_name, vshard,
                                   targets.dim() - axes.lead(table_shard))
    in_range = (local >= 0) & (local < vshard)
    idx = local.clamp(0, vshard - 1).long()[..., None]
    tgt = torch.gather(logits, -1, idx.expand(logits.shape[:-1] + (1,)))
    tgt = torch.where(in_range, tgt[..., 0], torch.zeros_like(tgt[..., 0]))
    return m + torch.log(se) - axes.psum(tgt, axis_name)
