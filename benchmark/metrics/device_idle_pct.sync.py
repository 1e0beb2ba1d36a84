"""``device_idle_pct.bw`` in the cells whose end-to-end metric is
``busbw_GBps.sync``."""

from metrics import load

read = load("device_idle_pct.bw").read
