"""Device ms a collective in the port's SUM combiner (``axpy_kernel``
of ``csrc/stream_ops.cu``)."""

import re

from metrics import collectives, device_seconds

AXPY = re.compile(r"axpy")


def read(ctx):
    n = collectives(ctx)
    s = device_seconds(ctx, AXPY)
    if not n or not s:
        return None
    return s / n * 1e3
