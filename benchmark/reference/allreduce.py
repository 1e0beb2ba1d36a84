"""MPI_Allreduce with SUM over a rank-stacked buffer: every rank's row
of the result is the sum of all ranks' rows."""

import torch

from . import BLOCK, worst


def bus_factor(n: int) -> float:
    return 2.0 * (n - 1) / n


def compute(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Every rank's result, the rows summed in ``dtype``."""
    s = x.to(dtype).sum(0, dtype=dtype)
    return s.unsqueeze(0).expand(x.shape).clone()


def max_gap(x: torch.Tensor, out: torch.Tensor) -> float:
    """max |out - sum over ranks of x| over every rank and element."""
    n = x.shape[0]
    xf, of = x.reshape(n, -1), out.reshape(n, -1)
    gap = 0.0
    for j in range(0, xf.shape[1], BLOCK):
        want = xf[:, j:j + BLOCK].double().sum(0)
        got = of[:, j:j + BLOCK].double()
        gap = max(gap, worst(got - want))
    return gap

