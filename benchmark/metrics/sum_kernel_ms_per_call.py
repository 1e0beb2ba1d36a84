"""Device ms a collective in the port's SUM combiners: ``axpy_kernel``
of ``csrc/stream_ops.cu``, where a reduction combines two buffers, and
``ring_fold_kernel`` of ``csrc/ring_ops.cu``, the tuned ring
allreduce's whole body on the card, which does that body's SUM in place
of ``axpy`` (and moves its chunks besides) in the ring cells."""

import re

from metrics import collectives, device_seconds

SUM_KERNELS = re.compile(r"axpy|ring_fold")


def read(ctx):
    n = collectives(ctx)
    s = device_seconds(ctx, SUM_KERNELS)
    if not n or not s:
        return None
    return s / n * 1e3
