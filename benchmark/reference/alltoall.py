"""MPI_Alltoall over a rank-stacked buffer: rank r's row holds n equal
blocks, block j bound for rank j; rank r receives block r of every
rank, in source order."""

import torch

from . import BLOCK, worst


def bus_factor(n: int) -> float:
    return (n - 1) / n


def compute(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    n = x.shape[0]
    blocks = x.to(dtype).reshape(n, n, -1)
    return blocks.transpose(0, 1).reshape(x.shape).contiguous()


def max_gap(x: torch.Tensor, out: torch.Tensor) -> float:
    """max |out - the exact permutation of x|."""
    n = x.shape[0]
    xb, ob = x.reshape(n, n, -1), out.reshape(n, n, -1)
    gap = 0.0
    for r in range(n):
        for s in range(n):
            for j in range(0, xb.shape[2], BLOCK):
                got = ob[r, s, j:j + BLOCK].double()
                want = xb[s, r, j:j + BLOCK].double()
                gap = max(gap, worst(got - want))
    return gap

