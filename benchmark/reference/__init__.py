"""Plain PyTorch references of the collectives the benchmark drives.

One module a collective, found by the traffic mix's ``collective``
name. Each gives ``bus_factor(n)`` (nccl-tests' bus-bandwidth factor),
``compute(x, dtype)`` (the result for a rank-stacked input, computed in
``dtype``: the control puts it in the program's place in a lower
precision) and ``max_gap(x, out)`` (the largest absolute difference
between a program output and the exact result, in float64, worked out
in blocks so that it fits beside the program's buffers). Nothing here
imports the program under test.
"""

import importlib


def for_collective(name: str):
    """The reference module of collective ``name``."""
    return importlib.import_module(f"{__name__}.{name}")


#: elements a block of the float64 comparison handles
BLOCK = 1 << 24


def worst(diff) -> float:
    """The largest |diff|; a NaN counts as an infinite gap."""
    return float(diff.abs().nan_to_num(nan=float("inf")).max())
