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
IEEE add).
"""

import pytest
import torch

from ompi_release_tpu_torch.ops import cuda_op
from ompi_release_tpu_torch.utils.errors import MPIError


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _ulp_ok(got, want, dtype):
    got, want = got.float(), want.float()
    if dtype is torch.float32:
        return torch.allclose(got, want, rtol=1e-6, atol=0)
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    return bool(((got - want).abs() <= ulp).all())


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
    assert cuda_op.LAUNCHES == {"sum": 1, "axpy": 2, "scale": 1,
                                "transpose": 1, "chain": 1}


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
