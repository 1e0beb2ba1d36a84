"""The port's CUDA streaming kernels on the card, held against their
plain PyTorch twins. Every test needs a CUDA device and skips without
one (the decision is taken inside the fixture, never at import).

Run on a machine with the card:
``python -m pytest tests/test_torch_cuda_kernels.py -q``.

Tolerances: ``sum`` bitwise (one IEEE add per element in both);
``axpy`` f32 rtol=1e-6 (the kernel multiplies and adds with explicit
round-to-nearest intrinsics, so it is in fact expected bitwise); bf16
within 1 bf16 ulp (both widen to f32 and round once: expected bitwise).
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
    assert cuda_op.LAUNCHES == {"sum": 1, "axpy": 2, "scale": 1}


def test_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    x = torch.ones(64, 64, device=dev)
    with pytest.raises(MPIError, match="contiguous"):
        cuda_op.sum_(x.t(), x)
    with pytest.raises(MPIError, match="float32/bfloat16"):
        cuda_op.scale(torch.ones(8, dtype=torch.int32, device=dev), 2.0)
    with pytest.raises(MPIError, match="differ"):
        cuda_op.sum_(x, torch.ones(64, device=dev))
