"""Pessimistic message logging — the vprotocol/pessimist analogue
(counterpart of ``ompi_release_tpu/p2p/vprotocol.py``).

The reference's pessimistic FT
(``ompi/mca/vprotocol/pessimist/vprotocol_pessimist.h:19-35``) keeps
two things: a sender-based payload log, and the receiver-side
*determinants* — for every nondeterministic event (a wildcard recv's
actual match) the outcome is logged so a restarted process replays the
exact same delivery order. Driver-mode recast:

* every send is recorded with a copy of its payload (the log IS the
  sender-based payload log; tensors are mutable, so the log keeps its
  own copy, which the sender's later writes cannot reach);
* every recv POSTING is recorded in order, and on completion the
  matched (source, tag) is filled in — the determinant;
* ``replay`` re-issues the whole event sequence in posting order
  against a fresh engine, with each wildcard recv pinned to its
  recorded match, so the restarted consumer sees byte-identical
  deliveries in the original order even when the first run matched
  racy ANY_SOURCE recvs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch

from ..mca import pvar
from ..utils import output
from ..utils.errors import ErrorCode, MPIError

_log = output.stream("vprotocol")
_logged = pvar.counter("vprotocol_logged_sends", "sends captured in the log")
_logged_recvs = pvar.counter(
    "vprotocol_logged_recvs", "recv postings captured in the log"
)


@dataclasses.dataclass
class LoggedSend:
    seq: int
    src: int
    dst: int
    tag: int
    data: Any
    sync: bool


@dataclasses.dataclass
class LoggedRecv:
    seq: int
    dst: int
    source: int          # as posted (may be ANY_SOURCE = -1)
    tag: int             # as posted (may be ANY_TAG = -1)
    matched_src: Optional[int] = None   # determinant, set on completion
    matched_tag: Optional[int] = None
    cancelled: bool = False  # MPI_Cancel'd: skipped on replay


class MessageLog:
    def __init__(self) -> None:
        self.events: List[Any] = []  # LoggedSend | LoggedRecv, in order

    # -- engine-side hooks -------------------------------------------------
    def record(self, src: int, dst: int, tag: int, data, sync: bool
               ) -> None:
        _logged.add()
        if isinstance(data, torch.Tensor):
            data = data.clone()
        self.events.append(
            LoggedSend(len(self.events), src, dst, tag, data, sync)
        )

    def record_recv_post(self, dst: int, source: int, tag: int,
                         req) -> None:
        """Log a recv posting; the determinant (which message matched)
        is filled in when the request completes."""
        _logged_recvs.add()
        ev = LoggedRecv(len(self.events), dst, source, tag)
        self.events.append(ev)

        def on_done(r) -> None:
            if r.status.cancelled:
                # a cancelled recv consumed nothing: replaying it as
                # a live wildcard would steal a later recv's message
                ev.cancelled = True
                return
            ev.matched_src = int(r.status.source)
            ev.matched_tag = int(r.status.tag)

        req.on_complete(on_done)

    def record_matched_recv(self, dst: int, source: int, tag: int,
                            matched_src: int, matched_tag: int) -> None:
        """Log an improbe/mrecv delivery: the match decision is made
        at probe time, so the determinant is complete immediately."""
        _logged_recvs.add()
        self.events.append(LoggedRecv(
            len(self.events), dst, source, tag,
            matched_src=int(matched_src), matched_tag=int(matched_tag),
        ))

    # -- restart side ------------------------------------------------------
    def replay(self, pml) -> List[Any]:
        """Re-issue the logged event sequence in posting order on a
        fresh engine. Wildcard recvs are pinned to their recorded
        determinants, so delivery order is reproduced exactly. Returns
        the re-delivered recv payloads in original posting order (what
        the restarted consumer consumes)."""
        reqs = []
        for ev in self.events:
            if isinstance(ev, LoggedSend):
                pml.isend(ev.data, ev.dst, ev.tag, src=ev.src, sync=False)
            else:
                if ev.cancelled:
                    continue  # consumed nothing; nothing to replay
                if ev.matched_src is None:
                    raise MPIError(
                        ErrorCode.ERR_PENDING,
                        f"recv event {ev.seq} has no determinant: the "
                        "original recv never completed — drain before "
                        "checkpointing the log",
                    )
                # the determinant replaces the wildcard: the fresh
                # engine MUST match the same message
                reqs.append(pml.irecv(
                    ev.matched_src, ev.matched_tag, dst=ev.dst
                ))
        values = []
        for r in reqs:
            r.wait()
            values.append(r.value)
        return values

    def clear(self) -> None:
        self.events.clear()


def attach(comm) -> MessageLog:
    """Enable pessimistic send+recv logging on this comm's PML."""
    log = MessageLog()
    comm.pml._logger = log
    return log


def detach(comm) -> None:
    pml = getattr(comm, "_pml", None)
    if pml is not None:
        pml._logger = None
