"""Context parallelism: ring attention over a ppermute K/V ring, and the
single-device attention reference.

Counterpart of ``ompi_release_tpu/parallel/cp.py:23-105``. Each sp rank
holds one block of the sequence (rank i holds global positions [i*Sb,
(i+1)*Sb)); K/V blocks rotate backwards around the ring, ``(i, i-1)``,
so at step s the resident block came from rank i+s, while every rank
accumulates its queries' attention against each passing block with an
online softmax; the causal mask compares global positions. The
arithmetic is the reference's, with its roundings: scores in f32, ``p``
rounded to ``v``'s dtype before the second product (``:38``), the output
in ``q``'s dtype. Tensors are (..., S, D); the leading dims are the
stacked layout's rank dims (inside a mesh), the heads and any batch dims
the model's ``vmap`` maps over. With one sp rank the ring has one step.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import axes

NEG_INF = -1e30


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``einsum('hqd,hkd->hqk', preferred_element_type=f32) / sqrt(D)``:
    bf16 widens exactly, so the f32 product is the f32-accumulated one."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) / \
        math.sqrt(q.shape[-1])


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``einsum(p.astype(v.dtype), v, preferred_element_type=f32)``."""
    return torch.matmul(p.to(v.dtype).float(), v.float())


def _block_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Q-block x K/V-block partial attention: (out_unnorm, row_max,
    row_sumexp) for online combination; mask (Sq, Sk) bool or None."""
    scores = _scores(q, k)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1)
    # rows that are fully masked contribute nothing (exp underflows to 0)
    p = torch.exp(scores - torch.clamp_min(m, NEG_INF / 2)[..., None])
    return _pv(p, v), m, p.sum(dim=-1)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   axis_name: str = "sp", causal: bool = False
                   ) -> torch.Tensor:
    """Exact blockwise attention with K/V rotating over the sp ring:
    (..., Sb, D) per rank -> (..., Sb, D) in q's dtype."""
    n = axes.axis_size_or_1(axis_name)
    rank = axes.axis_index(axis_name, q.dim() - axes.lead(q))
    sb = q.shape[-2]
    # send backwards so at step s the resident block originated at rank+s
    back = [(i, (i - 1) % n) for i in range(n)]
    pos = torch.arange(sb, device=q.device)
    qpos = rank * sb + pos[:, None]
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    row_m = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32,
                       device=q.device)
    row_l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    kc, vc = k, v
    for s in range(n):
        src = (rank + s) % n  # owner of the resident K/V block
        mask = (qpos >= src * sb + pos[None, :]) if causal else None
        out, m, l = _block_attn(q, kc, vc, mask)
        new_m = torch.maximum(row_m, m)
        alpha = torch.exp(row_m - new_m)  # rescale old accumulator
        beta = torch.exp(m - new_m)  # rescale incoming block
        acc = acc * alpha[..., None] + out * beta[..., None]
        row_l = row_l * alpha + l * beta
        row_m = new_m
        if s < n - 1:
            kc = axes.ppermute(kc, axis_name, back)
            vc = axes.ppermute(vc, axis_name, back)
    # fully-masked rows (none under causal self-attn) would have l == 0
    return (acc / torch.clamp_min(row_l, 1e-30)[..., None]).to(q.dtype)


def local_flash_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *,
                          causal: bool = False) -> torch.Tensor:
    """Single-device attention, the n = 1 reference for
    ``ring_attention``: softmax of the masked f32 scores."""
    scores = _scores(q, k)
    if causal:
        i = torch.arange(q.shape[-2], device=q.device)
        scores = torch.where(i[:, None] >= i[None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return _pv(p, v).to(q.dtype)
