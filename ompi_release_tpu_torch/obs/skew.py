"""Rank-skew metrics — per-collective arrival-spread estimation.

The imbalance signal a production trainer needs: how long a collective
sat between *arriving* at the dispatcher and its body actually
launching, versus the body itself. The coll driver marks three points
per call — arrive (dispatcher entry), body (compiled program launch,
after cache lookup / compile / validation / host staging), end — and
this module turns them into pvars:

  coll_<op>_skew_seconds   AGGREGATE  wait before the body launched
  coll_<op>_latency        HISTOGRAM  log2 buckets of body seconds
  coll_<op>_msg_bytes      HISTOGRAM  log2 buckets of payload sizes

plus one journal span per call covering arrive→end. In
single-controller driver mode every rank's arrival is the same host
call, so the spread estimate degenerates to the host-side wait; on a
spanning (multi-controller) communicator the wait includes genuine
cross-rank arrival spread — the body cannot start until the last
rank's frames arrive. Pvars are looked up through the registry on
every ``end`` (lock + dict hit) rather than cached: skew only runs
when obs is enabled, and registry-identity staleness across test
fixtures is worse than the lookup.
"""

from __future__ import annotations

import time

from ..mca import pvar as _pvar
from .journal import JOURNAL as _JOURNAL


class CollTimer:
    __slots__ = ("op", "comm_id", "t_arrive", "t_body")

    def __init__(self, op: str, comm_id: int) -> None:
        self.op = op
        self.comm_id = comm_id
        self.t_arrive = time.perf_counter()
        self.t_body = self.t_arrive


def begin(op: str, comm_id: int = -1) -> CollTimer:
    """Mark a collective's arrival at the dispatcher."""
    return CollTimer(op, comm_id)


def body(tok: CollTimer) -> None:
    """Mark the op body's launch; wait = now - arrival."""
    tok.t_body = time.perf_counter()


def end(tok: CollTimer, nbytes: int = 0) -> None:
    """Close the span: update skew/latency/size pvars + the journal."""
    now = time.perf_counter()
    op = tok.op
    _pvar.aggregate(
        f"coll_{op}_skew_seconds",
        f"wait before the {op} body launched (arrival-spread estimate)",
    ).observe(tok.t_body - tok.t_arrive)
    _pvar.histogram(
        f"coll_{op}_latency",
        f"{op} body seconds (dispatch-side), log2 buckets",
    ).observe(now - tok.t_body)
    _pvar.histogram(
        f"coll_{op}_msg_bytes",
        f"{op} payload bytes, log2 buckets",
    ).observe(nbytes)
    _JOURNAL.record(op, "coll", tok.t_arrive, now - tok.t_arrive,
                    nbytes=nbytes, comm_id=tok.comm_id)
