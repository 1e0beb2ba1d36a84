"""The port's CUDA kernels on the card, held against their plain
PyTorch twins. Every test needs a CUDA device and skips without
one (the decision is taken inside the fixture, never at import).

Run on a machine with the card:
``python -m pytest tests/test_torch_cuda_kernels.py -q``.

Tolerances: ``sum`` bitwise (one IEEE add per element in both);
``axpy`` f32 rtol=1e-6 (the kernel multiplies and adds with explicit
round-to-nearest intrinsics, so it is in fact expected bitwise); bf16
within 1 bf16 ulp (both widen to f32 and round once: expected bitwise);
``transpose`` and ``chain_hop`` bitwise (a move of 32-bit words; one
IEEE add). ``flash_fwd``: ``out`` f32 rtol/atol 2e-5 (the JAX suite's
own, ``tests/test_pallas.py``), bf16 within 1 bf16 ulp plus that atol,
``lse`` atol 1e-5; kernel and twin both compute in f32, in another
summation order, and each rounds its own f32 result to bf16 once: near
zero the two f32 sums differ by more than a bf16 ulp of the value.
``flash_bwd_dq`` / ``flash_bwd_dkv``: dq, dk, dv f32 rtol/atol 2e-4 (the
JAX suite's grad tolerance, ``tests/test_pallas.py:101``), bf16 within
1 bf16 ulp plus that atol, for the same reason as the forward: each
gradient is an f32 sum of up to S products taken in another order on
each side, and each side rounds its own sum once (the bf16 kernels feed
P and dS to the tensor cores as bf16 hi + lo pairs, which keeps them
within that rule: ``tests/test_torch_flash_split.py``). The backward is
bitwise deterministic (each output is owned by one block; no atomics).
"""

import pytest
import torch

from ompi_release_tpu_torch.ops import cuda_op
from ompi_release_tpu_torch.ops import flash_attention as fa
from ompi_release_tpu_torch.utils.errors import MPIError

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _ulp_ok(got, want, dtype, atol=0.0):
    got, want = got.float(), want.float()
    if dtype is torch.float32:
        return torch.allclose(got, want, rtol=1e-6, atol=0)
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    return bool(((got - want).abs() <= ulp + atol).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,offset", [(1, 0), (4097, 0), ((1 << 20) + 3, 0),
                                      (4097, 1)])
def test_kernels_match_plain_twins(dev, dtype, n, offset):
    g = torch.Generator(device=dev).manual_seed(n + offset)
    base = torch.randn(2, n + offset, generator=g, device=dev).to(dtype)
    a, b = base[0, offset:], base[1, offset:]  # offset 1: misaligned view
    assert a.is_contiguous()
    assert torch.equal(cuda_op.sum_(a, b), cuda_op._plain_sum(a, b))
    assert _ulp_ok(cuda_op.axpy(a, b, 0.999), cuda_op._plain_axpy(a, b, 0.999),
                   dtype)
    assert _ulp_ok(cuda_op.scale(a, 1.0001), cuda_op._plain_scale(a, 1.0001),
                   dtype)
    torch.cuda.synchronize()


def test_launches_counted_per_wrapper(dev):
    cuda_op.reset_launches()
    x = torch.ones(1000, device=dev)
    cuda_op.sum_(x, x)
    cuda_op.axpy(x, x, 2.0)
    cuda_op.axpy(x, x, 2.0)
    cuda_op.scale(x, 3.0)
    cuda_op.transpose(x.view(10, 100))
    cuda_op.chain_hop(torch.ones(cuda_op.CHAIN_TILE, device=dev))
    q = torch.ones(2, 70, 8, device=dev)
    fa.flash_forward(q, q, q, True)
    fa.flash_attention(q, q, q)
    fa._plain_flash_forward(q, q, q, True)  # the twin launches nothing
    qg = q.clone().requires_grad_()
    fa.flash_attention(qg, q, q, True).sum().backward()  # one backward
    out, lse = fa._plain_flash_forward(q, q, q, True)
    fa._plain_flash_backward(q, q, q, out, lse, q, True)
    assert cuda_op.LAUNCHES == {"sum": 1, "axpy": 2, "scale": 1,
                                "transpose": 1, "chain": 1, "flash_fwd": 3,
                                "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


def test_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    x = torch.ones(64, 64, device=dev)
    with pytest.raises(MPIError, match="contiguous"):
        cuda_op.sum_(x.t(), x)
    with pytest.raises(MPIError, match="float32/bfloat16"):
        cuda_op.scale(torch.ones(8, dtype=torch.int32, device=dev), 2.0)
    with pytest.raises(MPIError, match="differ"):
        cuda_op.sum_(x, torch.ones(64, device=dev))
    with pytest.raises(MPIError, match="contiguous"):
        cuda_op.transpose(x.t())
    with pytest.raises(MPIError, match="int32/float32"):
        cuda_op.transpose(x.to(torch.bfloat16))
    with pytest.raises(MPIError, match="float32 tile"):
        cuda_op.chain_hop(torch.ones(8, 256, device=dev))
    tile = torch.ones(2 * 8 * 128 + 1, device=dev)[1:1 + 8 * 128]
    with pytest.raises(MPIError, match="aligned"):
        cuda_op.chain_hop(tile.view(cuda_op.CHAIN_TILE))


@pytest.mark.parametrize("shape,dtype", [
    ((8192, 8192), torch.int32), ((4097, 1000), torch.float32),
    ((1, 1), torch.float32), ((33, 65), torch.int32),
    ((65535 * 32 + 40, 3), torch.int32),  # more tile rows than gridDim.y
])
def test_transpose_bitwise(dev, shape, dtype):
    g = torch.Generator(device=dev).manual_seed(shape[0])
    x = torch.randint(-2**31, 2**31 - 1, shape, generator=g, device=dev,
                      dtype=torch.int32).view(dtype)  # every bit pattern
    got = cuda_op.transpose(x)
    want = cuda_op._plain_transpose(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    torch.cuda.synchronize()


def test_chain_hop_and_loops(dev):
    x = torch.randn(cuda_op.CHAIN_TILE, device=dev)
    assert torch.equal(cuda_op.chain_hop(x), x + 1)
    a = torch.zeros(cuda_op.CHAIN_TILE, device=dev)
    k = cuda_op.GRAPH_BLOCK + 5  # one replay plus an eager remainder
    for graph in (False, True):
        loop = cuda_op.make_chain_loop(4, graph=graph)
        assert float(loop(a, k)) == 2 * 4 * k
        assert float(loop(a, 1)) == 8  # a replayed graph reads a afresh
    t_loop, _ = cuda_op.make_transpose_loop(256)
    b = torch.arange(256 * 256, device=dev, dtype=torch.int32).view(256, 256)
    assert int(t_loop(b, 3)) == 256 * 256 - 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [1, 100, 129, 2048])
@pytest.mark.parametrize("d", [8, 64, 128])
def test_flash_fwd_matches_plain_twin(dev, dtype, causal, s, d):
    g = torch.Generator(device=dev).manual_seed(s * 1000 + d)
    q, k, v = (torch.randn(3, s, d, generator=g, device=dev).to(dtype)
               for _ in range(3))
    out, lse = fa.flash_forward(q, k, v, causal)
    want, want_lse = fa._plain_flash_forward(q, k, v, causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and lse.dtype == torch.float32
    if dtype is torch.float32:
        assert torch.allclose(out, want, rtol=2e-5, atol=2e-5)
    else:
        assert _ulp_ok(out, want, dtype, atol=2e-5)
    assert torch.allclose(lse, want_lse, rtol=0, atol=1e-5)


def test_flash_fwd_full_width_and_batched_layout(dev):
    """The model's shape, (B, H, S, D) = (8, 8, 2048, 64) bf16 causal:
    the leading dims flatten into 64 heads of one launch."""
    g = torch.Generator(device=dev).manual_seed(64)
    q, k, v = (torch.randn(8, 8, 2048, 64, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    out, lse = fa.flash_forward(q, k, v, True)
    want, want_lse = fa._plain_flash_forward(
        *(t.view(64, 2048, 64) for t in (q, k, v)), True)
    torch.cuda.synchronize()
    assert out.shape == q.shape and lse.shape == (8, 8, 2048)
    assert _ulp_ok(out.view(64, 2048, 64), want, torch.bfloat16, atol=2e-5)
    assert torch.allclose(lse.view(64, 2048), want_lse, rtol=0, atol=1e-5)


def test_flash_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    q = torch.randn(2, 64, 64, device=dev)
    with pytest.raises(MPIError, match="contiguous"):
        fa.flash_forward(q.transpose(1, 2).contiguous().transpose(1, 2),
                         q, q, True)
    big = torch.randn(2, 64, 129, device=dev)
    with pytest.raises(MPIError, match="head dim 129"):
        fa.flash_forward(big, big, big, True)
    h = q.half()
    with pytest.raises(MPIError, match="float32/bfloat16"):
        fa.flash_forward(h, h, h, True)
    with pytest.raises(MPIError, match="differ"):
        fa.flash_forward(q, q.cpu(), q, True)
    with pytest.raises(MPIError, match="65535"):
        w = torch.empty(65536, 1, 1, device=dev)
        fa.flash_forward(w, w, w, True)
    # under grad the backward runs the kernels and matches the twin
    qg = q.clone().requires_grad_()
    out = fa.flash_attention(qg, q, q)
    (dq,) = torch.autograd.grad(out, qg, torch.ones_like(out))
    o, lse = fa._plain_flash_forward(q, q, q, False)
    want = fa._plain_flash_backward(q, q, q, o, lse, torch.ones_like(q),
                                    False)[0]
    assert torch.allclose(dq, want, rtol=2e-4, atol=2e-4)
    with pytest.raises(MPIError, match="contiguous"):
        fa.flash_backward(q, q, q, o, lse, q.transpose(1, 2).contiguous()
                          .transpose(1, 2), True)
    with pytest.raises(MPIError, match="lse"):
        fa.flash_backward(q, q, q, o, lse.to(torch.bfloat16), q, True)


def _bwd_inputs(dev, dtype, shape, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(*shape, generator=g, device=dev).to(dtype)
                   for _ in range(4))
    return q, k, v, do


def _grads_close(got, want, dtype):
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        if dtype is torch.float32:
            assert torch.allclose(a, b, rtol=2e-4, atol=2e-4)
        else:
            assert _ulp_ok(a, b, dtype, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [1, 100, 129, 256])
@pytest.mark.parametrize("d", [8, 64, 128])
def test_flash_bwd_matches_plain_twin(dev, dtype, causal, s, d):
    q, k, v, do = _bwd_inputs(dev, dtype, (3, s, d), s * 1000 + d)
    out, lse = fa.flash_forward(q, k, v, causal)
    got = fa.flash_backward(q, k, v, out, lse, do, causal)
    want = fa._plain_flash_backward(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    _grads_close(got, want, dtype)


def test_flash_bwd_full_width_deterministic_and_batched(dev):
    """The model's shape, (B, H, S, D) = (8, 8, 2048, 64) bf16 causal,
    through autograd with the model's transposed cotangent; two runs of
    the backward are bitwise equal."""
    q, k, v, do = _bwd_inputs(dev, torch.bfloat16, (8, 8, 2048, 64), 64)
    out, lse = fa.flash_forward(q, k, v, True)
    want = fa._plain_flash_backward(
        *(t.view(64, 2048, 64) for t in (q, k, v, out)), lse.view(64, 2048),
        do.view(64, 2048, 64), True)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    g_t = do.transpose(1, 2).contiguous().transpose(1, 2)  # not contiguous
    first = torch.autograd.grad(fa.flash_attention(*leaves, True), leaves,
                                g_t)
    again = fa.flash_backward(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    _grads_close([t.view(64, 2048, 64) for t in first], want, torch.bfloat16)
    for a, b in zip(first, again):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_flash_bwd_full_width_d128(dev):
    """The model's width in 128-wide heads, (B, H, S, D) = (8, 4, 2048,
    128) bf16 causal: the tensor-core kernels at their wider instance,
    against the plain twin; two runs bitwise equal."""
    q, k, v, do = _bwd_inputs(dev, torch.bfloat16, (8, 4, 2048, 128), 128)
    out, lse = fa.flash_forward(q, k, v, True)
    got = fa.flash_backward(q, k, v, out, lse, do, True)
    again = fa.flash_backward(q, k, v, out, lse, do, True)
    want = fa._plain_flash_backward(
        *(t.view(32, 2048, 128) for t in (q, k, v, out)), lse.view(32, 2048),
        do.view(32, 2048, 128), True)
    torch.cuda.synchronize()
    _grads_close([t.view(32, 2048, 128) for t in got], want, torch.bfloat16)
    for a, b in zip(got, again):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("d,offset", [(20, 0), (72, 0), (64, 1)])
def test_flash_bwd_bf16_element_loads(dev, d, offset):
    """The bf16 kernels copy 16-byte rows only when D % 8 == 0 and every
    operand is 16-byte aligned; a head dim of 20 and views at element
    offset 1 take their element loads instead, 72 the wider instance."""
    g = torch.Generator(device=dev).manual_seed(d + offset)
    n = 2 * 100 * d
    q, k, v, do = (torch.randn(n + offset, generator=g, device=dev)
                   .to(torch.bfloat16)[offset:].view(2, 100, d)
                   for _ in range(4))
    out, lse = fa.flash_forward(q, k, v, True)
    got = fa.flash_backward(q, k, v, out, lse, do, True)
    want = fa._plain_flash_backward(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    _grads_close(got, want, torch.bfloat16)
