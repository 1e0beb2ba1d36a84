"""Device ms a collective in PyTorch's index, gather, concatenation and
device-to-device copy kernels: the runner's data movement."""

from metrics import RUNNER_COPY, collectives, device_seconds


def read(ctx):
    n = collectives(ctx)
    s = device_seconds(ctx, RUNNER_COPY)
    if not n or not s:
        return None
    return s / n * 1e3
