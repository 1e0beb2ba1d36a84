"""Lockstep in-memory exchange world — the minimal simulator.

One thread per simulated process, one FIFO queue per (src, dst) pair,
and the exact transport contract the real ``coll/hier._XchgAdapter``
provides: all of a round's sends are posted before any receive parks.
The pure schedules of ``coll/hier_schedules.py`` run under it
unmodified, which is what lets the bitwise-parity matrix cover the
whole (P, op, dtype, algorithm) cross product in milliseconds,
device- and process-free.

Extracted from ``tests/test_hier_schedules.py`` so the simulator is a
first-class citizen: the parity tests import it from here, and
:mod:`.fleet_sim` scales the same adapter contract to thousands of
ranks with a fabric model on top.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Sequence

import numpy as np


class SimWorld:
    """Per-(src, dst) FIFO queues for one simulated process set."""

    def __init__(self, procs: Sequence[int]) -> None:
        self.q = {(s, d): queue.Queue() for s in procs for d in procs}


class SimXchg:
    """In-memory exchange adapter: per-(src, dst) FIFO, all sends
    posted before any receive parks — the wire adapter's contract."""

    def __init__(self, world: SimWorld, me: int) -> None:
        self.world, self.me = world, me

    def exchange(self, sends: Dict[int, list],
                 recvs: Dict[int, int]) -> Dict[int, list]:
        for dst, arrs in sends.items():
            for a in arrs:
                self.world.q[(self.me, dst)].put(np.asarray(a))
        return {
            src: [self.world.q[(src, self.me)].get(timeout=30)
                  for _ in range(c)]
            for src, c in recvs.items()
        }


def simulate(procs: Sequence[int], fn: Callable, timeout: float = 60):
    """Run ``fn(xchg, pidx)`` on one thread per process; returns
    {pidx: result}; any thread's exception is re-raised as an
    AssertionError naming the failing process."""
    world = SimWorld(procs)
    out, errs = {}, {}

    def worker(p):
        try:
            out[p] = fn(SimXchg(world, p), p)
        except Exception as e:  # pragma: no cover - failure path
            errs[p] = e

    ts = [threading.Thread(target=worker, args=(p,), daemon=True)
          for p in procs]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
    assert not errs, errs
    assert len(out) == len(procs), f"threads hung: {sorted(out)}"
    return out
