"""``coll_roofline`` in the gradient-sync cell, where it moves
``busbw_GBps.sync``."""

from metrics import load

read = load("coll_roofline").read
