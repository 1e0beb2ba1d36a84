"""The port's flash-attention backward, held against the JAX package's.

The reference is ``jax.grad`` of ``(flash_attention(q, k, v, causal,
bq, bk, interpret=True) * w).sum()``: the Pallas backward
(``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` behind the ``custom_vjp``)
run in interpret mode on the CPU, as ``tests/test_pallas.py`` runs it.
The port's side is ``torch.autograd.grad`` of the same weighted sum of
``flash_attention`` (the autograd Function; on the CPU its backward is
the plain twin ``_plain_flash_backward``, not autograd through the plain
forward), and the twin called directly with JAX's blocks. Inputs and
the cotangent weights ``w`` are made by numpy from a seed.

Tolerances: f32 rtol/atol 2e-4 (``tests/test_pallas.py:101``, the JAX
suite's grad tolerance); bf16 3e-2 (its bf16 tolerance).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ompi_release_tpu.ops.pallas_attention import flash_attention as jflash
from ompi_release_tpu_torch.ops import cuda_op
from ompi_release_tpu_torch.ops import flash_attention as tfa

BLOCKS = [64, 128]  # (block_q, block_k) = (b, b)
F32_CASES = [(s, d, b) for s in (1, 100, 129, 256) for d in (8, 64)
             for b in BLOCKS]
BF16_CASES = [(1, 64, 64), (100, 8, 128), (129, 64, 64), (256, 64, 128)]


def _inputs(s, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(3, s, d).astype(np.float32) for _ in range(4)]


def _jax_grads(q, k, v, w, causal, block, jdt):
    def loss(q, k, v):
        out = jflash(q, k, v, causal, block, block, True)
        return (out.astype(jnp.float32) * w).sum()

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_grads(q, k, v, w, causal, tdt):
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*leaves, causal)
    assert out.dtype == tdt
    loss = (out.float() * torch.from_numpy(w)).sum()
    return [g.float().numpy() for g in torch.autograd.grad(loss, leaves)]


def _twin_grads(q, k, v, w, causal, block, tdt):
    q, k, v = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    out, lse = tfa._plain_flash_forward(q, k, v, causal, block, block)
    # the cotangent of out: w cast to out's dtype, as the autograd path
    # hands it (d(out.float() * w)/d out)
    g = torch.from_numpy(w).to(tdt)
    return [t.float().numpy() for t in tfa._plain_flash_backward(
        q, k, v, out, lse, g, causal, block, block)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,d,block", F32_CASES)
def test_flash_grads_match_pallas_f32(s, d, block, causal):
    q, k, v, w = _inputs(s, d, seed=s * 7 + d + block)
    want = _jax_grads(q, k, v, w, causal, block, jnp.float32)
    before = dict(cuda_op.LAUNCHES)
    for got in (_port_grads(q, k, v, w, causal, torch.float32),
                _twin_grads(q, k, v, w, causal, block, torch.float32)):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)
            assert np.isfinite(a).all()
    assert cuda_op.LAUNCHES == before  # CPU tensors never reach a kernel


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,d,block", BF16_CASES)
def test_flash_grads_match_pallas_bf16(s, d, block, causal):
    q, k, v, w = _inputs(s, d, seed=s + d)
    want = _jax_grads(q, k, v, w, causal, block, jnp.bfloat16)
    for got in (_port_grads(q, k, v, w, causal, torch.bfloat16),
                _twin_grads(q, k, v, w, causal, block, torch.bfloat16)):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=3e-2, atol=3e-2)


def test_flash_backward_layout_and_transposed_cotangent():
    """The model's layout (mb, H, S, D) and the cotangent autograd hands
    it (a transposed view): the backward equals the twin on the
    flattened heads, and the wrapper takes a non-contiguous ``g`` on the
    CPU."""
    rng = np.random.RandomState(11)
    q, k, v = (torch.from_numpy(rng.randn(2, 3, 40, 8).astype(np.float32))
               for _ in range(3))
    g = torch.from_numpy(rng.randn(2, 40, 3, 8).astype(np.float32))
    g = g.transpose(1, 2)  # (2, 3, 40, 8), not contiguous
    out, lse = tfa.flash_forward(q, k, v, True)
    got = tfa.flash_backward(q, k, v, out, lse, g, True)
    want = tfa._plain_flash_backward(
        *(t.reshape(6, 40, 8) for t in (q, k, v, out)), lse.reshape(6, 40),
        g.reshape(6, 40, 8), True)
    for a, b in zip(got, want):
        assert a.shape == q.shape
        assert torch.equal(a.reshape(6, 40, 8), b)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    attn = tfa.flash_attention(*leaves, True)
    auto = torch.autograd.grad(attn.transpose(1, 2), leaves, g.transpose(1, 2))
    for a, b in zip(auto, got):
        assert torch.equal(a, b)
    empty = q[:, :, :0]
    assert all(t.shape == empty.shape for t in tfa.flash_backward(
        empty, empty, empty, empty, lse[:, :, :0], empty, True))


def test_flash_double_backward_raises():
    """The backward is once-differentiable: the kernels' outputs carry no
    graph, so a second derivative raises (on the CPU too, where the twin
    is plain torch code) instead of coming out wrong on the card."""
    rng = np.random.RandomState(12)
    leaves = [torch.from_numpy(rng.randn(2, 16, 8).astype(np.float32))
              .requires_grad_() for _ in range(3)]
    out = tfa.flash_attention(*leaves, True)
    # (out * out).sum(): the cotangent 2 * out carries a graph
    dq, = torch.autograd.grad((out * out).sum(), leaves[0], create_graph=True)
    with pytest.raises(RuntimeError, match="differentiate twice"):
        dq.sum().backward()
