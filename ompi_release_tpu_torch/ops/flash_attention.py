"""Flash attention: the hand-written CUDA kernels, their plain PyTorch
twins and the autograd wiring.

Counterpart of ``ompi_release_tpu/ops/pallas_attention.py``. The kernels
are ``flash_fwd`` (``csrc/flash_attn.cu``) and ``flash_bwd_dq`` /
``flash_bwd_dkv`` (``csrc/flash_attn_bwd.cu``: f32 on the CUDA cores;
bf16 on the tensor cores, ``csrc/flash_attn_bwd_wgmma.cu``), built with
the port's other kernels by :func:`cuda_op.build` and launched through
``ctypes``; each source comment gives its design and bound.

- :func:`_plain_flash_forward` / :func:`_plain_flash_backward`: the
  arithmetic of ``_attn_kernel`` (``pallas_attention.py:38-88``) and of
  ``_flash_backward`` (``:235-307``) in PyTorch, one block at a time.
- :func:`flash_forward`: ``(out, lse)`` for ``q, k, v`` of shape
  ``(..., S, D)`` (the JAX layout ``(H, S, D)`` with any leading batch
  dims, the model's ``vmap`` written out).
- :func:`flash_backward`: ``(dq, dk, dv)`` from the forward's residuals
  and the cotangent.
- :func:`flash_attention`: ``out``, differentiable: a
  ``torch.autograd.Function`` whose forward is :func:`flash_forward`
  and whose backward is :func:`flash_backward` (the ``custom_vjp`` of
  ``pallas_attention.py:323-356``).

A CUDA tensor launches the kernels; a CPU tensor takes the plain twins.
What a kernel does not take raises; nothing falls back.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..utils.errors import ErrorCode, MPIError
from . import cuda_op

NEG_INF = -1e30
#: the largest head dim the kernels take (the f32 kernels' accumulators
#: hold 128 columns; the bf16 ones pad the head dim to 64 or 128)
MAX_HEAD_DIM = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _scale(d: int) -> torch.Tensor:
    """rsqrt(D) in f32, as the Pallas kernels compute it; the kernels are
    handed this same value."""
    return torch.rsqrt(torch.tensor(float(d), dtype=torch.float32))


def _plain_flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, block_q: int = 128,
                         block_k: int = 128
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_attn_kernel``'s arithmetic on ``(N, S, D)``: q widened to f32
    and scaled by rsqrt(D), K/V zero-padded to whole ``block_k`` blocks
    (the pad masked by ``k_pos < S``, never read as data), the causal
    mask ``q_pos >= k_pos`` with the ``NEG_INF`` sentinel, running
    max/sum-exp in f32, ``out = acc / max(l, 1e-30)`` rounded once to the
    input dtype and ``lse = m + log(max(l, 1e-30))`` in f32 (finite on
    every row). Vectorised over heads and q-rows; rows are independent,
    so ``block_q`` only has to be positive, as in the Pallas call."""
    if block_q < 1 or block_k < 1:
        raise MPIError(ErrorCode.ERR_ARG, "flash blocks must be positive")
    n, s, d = q.shape
    bk = min(block_k, s)
    nk = -(-s // bk)
    pad = nk * bk - s
    kf = F.pad(k.float(), (0, 0, 0, pad))
    vf = F.pad(v.float(), (0, 0, 0, pad))
    qs = q.float() * _scale(d).to(q.device)
    q_pos = torch.arange(s, device=q.device)[:, None]
    acc = torch.zeros(n, s, d, dtype=torch.float32, device=q.device)
    row_m = torch.full((n, s), NEG_INF, dtype=torch.float32, device=q.device)
    row_l = torch.zeros(n, s, dtype=torch.float32, device=q.device)
    for jk in range(nk):
        k_blk = kf[:, jk * bk:(jk + 1) * bk]
        v_blk = vf[:, jk * bk:(jk + 1) * bk]
        sc = torch.matmul(qs, k_blk.transpose(-1, -2))  # (n, s, bk)
        k_pos = jk * bk + torch.arange(bk, device=q.device)[None, :]
        mask = k_pos < s  # tail padding
        if causal:
            mask = mask & (q_pos >= k_pos)
        sc = torch.where(mask, sc, NEG_INF)
        m = torch.maximum(row_m, sc.amax(dim=-1))
        p = torch.exp(sc - m[..., None])
        alpha = torch.exp(row_m - m)
        acc = acc * alpha[..., None] + torch.matmul(p, v_blk)
        row_l = row_l * alpha + p.sum(dim=-1)
        row_m = m
    l = torch.clamp_min(row_l, 1e-30)
    return (acc / l[..., None]).to(q.dtype), row_m + torch.log(l)


def _delta(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in f32, outside the kernels as in
    ``pallas_attention.py:244-246``."""
    return (g.float() * out.float()).sum(dim=-1)


def _padded(q, k, v, lse, g, delta, block_q, block_k):
    """``(bq, bk, qs, k, v, lse, g, delta)``: the blocks (at most S) and
    the backward's operands in f32, zero-padded along the sequence to
    whole blocks as ``_flash_backward`` pads them (``q``, ``g``, ``lse``,
    ``delta`` to ``bq``, K/V to ``bk``), ``qs`` scaled by rsqrt(D)."""
    if block_q < 1 or block_k < 1:
        raise MPIError(ErrorCode.ERR_ARG, "flash blocks must be positive")
    s, d = q.shape[-2:]
    bq, bk = min(block_q, s), min(block_k, s)
    sq, sk = -(-s // bq) * bq, -(-s // bk) * bk

    def pad(x, to):  # the sequence axis (dim 1) up to ``to`` rows
        return F.pad(x.float(), (0, 0) * (x.dim() - 2) + (0, to - s))

    return (bq, bk, pad(q, sq) * _scale(d).to(q.device), pad(k, sk),
            pad(v, sk), pad(lse, sq), pad(g, sq), pad(delta, sq))


def _mask(q_pos, k_pos, s, causal):
    """``(q_pos < S) & (k_pos < S)`` [& ``q_pos >= k_pos``], (Q, K)."""
    m = (q_pos[:, None] < s) & (k_pos[None, :] < s)
    return m & (q_pos[:, None] >= k_pos[None, :]) if causal else m


def _plain_bwd_dq(q, k, v, lse, g, delta, causal, block_q=128,
                  block_k=128) -> torch.Tensor:
    """``_bwd_dq_kernel``'s arithmetic on ``(N, S, D)`` (``lse``,
    ``delta`` (N, S) f32), every q-block at once: over the k-blocks,
    ``P = where(mask, exp(qs k^T - lse), 0)``, ``dS = P * (dO v^T -
    delta)``, ``dq += dS k``; then ``dq * rsqrt(D)`` rounded once to q's
    dtype."""
    s, d = q.shape[-2:]
    bq, bk, qs, kf, vf, lse_p, do, dlt = _padded(q, k, v, lse, g, delta,
                                                 block_q, block_k)
    q_pos = torch.arange(qs.shape[1], device=q.device)
    dq = torch.zeros_like(qs)
    for k0 in range(0, kf.shape[1], bk):
        k_blk, v_blk = kf[:, k0:k0 + bk], vf[:, k0:k0 + bk]
        k_pos = torch.arange(k0, k0 + bk, device=q.device)
        p = torch.where(_mask(q_pos, k_pos, s, causal),
                        torch.exp(torch.matmul(qs, k_blk.transpose(-1, -2))
                                  - lse_p[..., None]), 0.0)
        dp = torch.matmul(do, v_blk.transpose(-1, -2))
        dq = dq + torch.matmul(p * (dp - dlt[..., None]), k_blk)
    return (dq[:, :s] * _scale(d).to(q.device)).to(q.dtype)


def _plain_bwd_dkv(q, k, v, lse, g, delta, causal, block_q=128,
                   block_k=128) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_bwd_dkv_kernel``'s arithmetic, every k-block at once: over the
    q-blocks, ``dv += P^T dO`` and ``dk += dS^T qs`` (``qs`` already
    carries rsqrt(D)); each rounded once to its input's dtype."""
    s = q.shape[-2]
    bq, bk, qs, kf, vf, lse_p, do, dlt = _padded(q, k, v, lse, g, delta,
                                                 block_q, block_k)
    k_pos = torch.arange(kf.shape[1], device=q.device)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for q0 in range(0, qs.shape[1], bq):
        rows = slice(q0, q0 + bq)
        q_blk, do_blk = qs[:, rows], do[:, rows]
        q_pos = torch.arange(q0, q0 + bq, device=q.device)
        p = torch.where(_mask(q_pos, k_pos, s, causal),
                        torch.exp(torch.matmul(q_blk, kf.transpose(-1, -2))
                                  - lse_p[:, rows, None]), 0.0)
        dv = dv + torch.matmul(p.transpose(-1, -2), do_blk)
        dp = torch.matmul(do_blk, vf.transpose(-1, -2))
        ds = p * (dp - dlt[:, rows, None])
        dk = dk + torch.matmul(ds.transpose(-1, -2), q_blk)
    return dk[:, :s].to(k.dtype), dv[:, :s].to(v.dtype)


def _plain_flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          out: torch.Tensor, lse: torch.Tensor,
                          g: torch.Tensor, causal: bool, block_q: int = 128,
                          block_k: int = 128
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """``_flash_backward``'s arithmetic on ``(N, S, D)`` (``lse`` (N, S)
    f32): ``delta = rowsum(g * out)`` in f32, then the dq sweep over
    k-blocks and the dk/dv sweep over q-blocks (:func:`_plain_bwd_dq`,
    :func:`_plain_bwd_dkv`)."""
    delta = _delta(out, g)
    args = (q, k, v, lse, g, delta, causal, block_q, block_k)
    return (_plain_bwd_dq(*args), *_plain_bwd_dkv(*args))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           name: str = "flash_forward") -> None:
    for t in (k, v):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise MPIError(ErrorCode.ERR_ARG,
                           f"{name}: operands differ in shape, dtype or "
                           f"device ({tuple(q.shape)} {q.dtype} {q.device} vs "
                           f"{tuple(t.shape)} {t.dtype} {t.device})")
    if q.dim() < 3:
        raise MPIError(ErrorCode.ERR_ARG,
                       f"{name}: q, k, v are (..., S, D) with at least "
                       f"one head dim, got {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODE:
        raise MPIError(ErrorCode.ERR_TYPE,
                       f"{name}: the kernel takes float32/bfloat16, "
                       f"got {q.dtype}")
    if not 1 <= q.shape[-1] <= MAX_HEAD_DIM:
        raise MPIError(ErrorCode.ERR_ARG,
                       f"{name}: head dim {q.shape[-1]} outside the "
                       f"kernel's 1..{MAX_HEAD_DIM}")


def _check_launch(name: str, *ts: torch.Tensor) -> int:
    """The kernels' extra conditions on CUDA tensors; returns N, the
    heads of one launch."""
    for t in ts:
        if not t.is_contiguous():
            raise MPIError(ErrorCode.ERR_ARG,
                           f"{name}: the kernel takes contiguous tensors")
    s, d = ts[0].shape[-2:]
    n = ts[0].numel() // (s * d)
    if n > 65535:
        raise MPIError(ErrorCode.ERR_ARG,
                       f"{name}: {n} heads exceed the kernel grid's 65535")
    return n


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of attention over the last two dims of ``(..., S,
    D)`` tensors: ``out`` in the input dtype, ``lse`` ``(..., S)`` f32.
    The leading dims flatten into N heads of one launch."""
    _check(q, k, v)
    lead, (s, d) = q.shape[:-2], q.shape[-2:]
    if q.numel() == 0:
        return torch.empty_like(q), torch.empty(
            *lead, s, dtype=torch.float32, device=q.device)
    if q.device.type == "cpu":
        out, lse = _plain_flash_forward(q.reshape(-1, s, d),
                                        k.reshape(-1, s, d),
                                        v.reshape(-1, s, d), causal)
        return out.view(q.shape), lse.view(*lead, s)
    n = _check_launch("flash_forward", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(*lead, s, dtype=torch.float32, device=q.device)
    lib = cuda_op._load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                            v.data_ptr(), out.data_ptr(), lse.data_ptr(), n,
                            s, d, float(_scale(d)), int(bool(causal)),
                            stream)
    cuda_op._raise_on("flash_fwd", err)
    cuda_op.LAUNCHES["flash_fwd"] += 1
    return out, lse


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                   causal: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of attention at ``q, k, v`` for the cotangent
    ``g`` of ``out``, from the forward's ``out`` and ``lse`` (all as
    :func:`flash_forward` takes and returns them). On CUDA tensors
    ``delta`` is one f32 reduction and the two kernels follow."""
    _check(q, k, v, "flash_backward")
    _check(q, out, g, "flash_backward")
    lead, (s, d) = q.shape[:-2], q.shape[-2:]
    if tuple(lse.shape) != (*lead, s) or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise MPIError(ErrorCode.ERR_ARG,
                       f"flash_backward: lse must be {(*lead, s)} float32 on "
                       f"{q.device}, got {tuple(lse.shape)} {lse.dtype} "
                       f"{lse.device}")
    if q.numel() == 0:
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.device.type == "cpu":
        grads = _plain_flash_backward(
            *(t.reshape(-1, s, d) for t in (q, k, v, out)),
            lse.reshape(-1, s), g.reshape(-1, s, d), causal)
        return tuple(t.view(q.shape) for t in grads)
    _check_launch("flash_backward", q, k, v, out, g, lse[..., None])
    delta = _delta(out, g)
    return (_bwd_dq_kernel(q, k, v, lse, g, delta, causal),
            *_bwd_dkv_kernel(q, k, v, lse, g, delta, causal))


def _bwd_launch(name: str, outs, q, k, v, lse, g, delta, causal) -> None:
    """One launch of backward kernel ``name`` on checked CUDA tensors."""
    s, d = q.shape[-2:]
    ptrs = [t.data_ptr() for t in (q, k, v, g, lse, delta, *outs)]
    lib = cuda_op._load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, name)(_DTYPE_CODE[q.dtype], *ptrs,
                                 q.numel() // (s * d), s, d,
                                 float(_scale(d)), int(bool(causal)), stream)
    cuda_op._raise_on(name, err)
    cuda_op.LAUNCHES[name] += 1


def _bwd_dq_kernel(q, k, v, lse, g, delta, causal) -> torch.Tensor:
    """dq by ``flash_bwd_dq``, the twin of :func:`_plain_bwd_dq`."""
    dq = torch.empty_like(q)
    _bwd_launch("flash_bwd_dq", (dq,), q, k, v, lse, g, delta, causal)
    return dq


def _bwd_dkv_kernel(q, k, v, lse, g, delta, causal
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) by ``flash_bwd_dkv``, the twin of :func:`_plain_bwd_dkv`."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("flash_bwd_dkv", (dk, dv), q, k, v, lse, g, delta, causal)
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """``flash_attention``'s ``custom_vjp`` (``pallas_attention.py:
    339-353``): the forward keeps ``q, k, v, out, lse`` (O(S·D), never
    (S, S)); the backward runs the flash backward on them. The kernels'
    outputs carry no graph, so a second derivative raises on every
    device rather than come out wrong on the card."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        # autograd hands the cotangent of a transposed view; the kernels
        # take contiguous tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, g.contiguous(),
                                    ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Blocked attention ``(..., S, D) -> (..., S, D)``, differentiable
    in ``q``, ``k`` and ``v`` through the flash backward."""
    return _FlashAttention.apply(q, k, v, bool(causal))
