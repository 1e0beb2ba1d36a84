"""``device_idle_pct.bw`` in the cells whose end-to-end metric is
``latency_us_p95``."""

from metrics import load

read = load("device_idle_pct.bw").read
