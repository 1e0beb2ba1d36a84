"""Tensor parallelism at tp = 1: the sharded linear layers, embedding
and loss of ``ompi_release_tpu/parallel/tp.py:35-128`` on one shard.

With one tp rank the shard is the whole tensor and every psum, pmax and
all_gather is the identity, so what remains is each function's local
math, kept in the reference's order and precision: matmuls accumulate
in f32 and round once to the input dtype (``preferred_element_type=f32``
then ``astype``), and the loss works on f32 logits. The collectives of
tp > 1 (and the options that select them, ``gather_output`` and
``scatter_output``), and the bias terms no caller passes yet, come with
the multi-card slice (ROADMAP queue 1 item 13).
"""

from __future__ import annotations

import torch


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # cuBLAS and the CPU kernels accumulate bf16 products in f32 and round
    # the output once: preferred_element_type=f32 followed by astype
    return torch.matmul(x, w)


def column_parallel(x: torch.Tensor, w_shard: torch.Tensor) -> torch.Tensor:
    """``y = x @ w_shard``: x (..., D), w_shard (D, F)."""
    return _matmul(x, w_shard).to(x.dtype)


def row_parallel(x_shard: torch.Tensor, w_shard: torch.Tensor) -> torch.Tensor:
    """``y = x_shard @ w_shard``: the psum of partial products over one
    rank."""
    return _matmul(x_shard, w_shard).to(x_shard.dtype)


def vocab_parallel_embedding(ids: torch.Tensor,
                             table_shard: torch.Tensor) -> torch.Tensor:
    """Rows of ``table_shard`` (V, D) for ``ids``; ids outside [0, V)
    give zero rows, as an out-of-shard id does in the reference."""
    vshard = table_shard.shape[0]
    in_range = (ids >= 0) & (ids < vshard)
    rows = table_shard[ids.clamp(0, vshard - 1).long()]
    return torch.where(in_range[..., None], rows, torch.zeros_like(rows))


def vocab_parallel_xent(h: torch.Tensor, table_shard: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
    """Per-token ``-log p(target)`` of the tied-embedding LM head:
    ``m + log(sum(exp(logits - m))) - logits[target]`` over f32 logits
    (h and table f32), with ``m`` the row max carrying no gradient; a
    target outside [0, V) contributes a zero target logit."""
    logits = torch.matmul(h, table_shard.t())
    # the max shift is for numerical stability only: no gradient flows
    # through it (the reference's _pmax_nograd, tp.py:22-33)
    m = logits.amax(dim=-1).detach()
    se = torch.exp(logits - m[..., None]).sum(dim=-1)
    vshard = table_shard.shape[0]
    in_range = (targets >= 0) & (targets < vshard)
    tgt = torch.gather(logits, -1,
                       targets.clamp(0, vshard - 1)[..., None].long())[..., 0]
    return m + torch.log(se) - torch.where(in_range, tgt,
                                           torch.zeros_like(tgt))
