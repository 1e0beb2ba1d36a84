"""``runner_copy_ms_per_call`` in the gradient-sync cell, where it moves
``busbw_GBps.sync``."""

from metrics import load

read = load("runner_copy_ms_per_call").read
