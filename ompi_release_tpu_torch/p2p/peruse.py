"""PERUSE — event callbacks on P2P internals.

The reference's PERUSE spec (``ompi/peruse/peruse.h:24,55``) lets
tools observe request lifecycle events inside the ob1 engine:
activation, matching, transfer begin/end. Same events here, fired by
the PML at the equivalent points. Registration is per communicator and
per event; the hooks cost one dict lookup when no subscriber exists.
"""

from __future__ import annotations

import time as _time
from typing import Callable, Dict, List

from .. import obs as _obs

# event names (the PERUSE_COMM_* set that maps onto this engine)
REQ_ACTIVATE = "req_activate"        # send/recv posted
REQ_MATCH_UNEX = "req_match_unex"    # recv matched an unexpected send
MSG_UNEX_INSERT = "msg_unex_insert"  # send queued unexpected
REQ_XFER_BEGIN = "req_xfer_begin"    # payload movement started
REQ_XFER_END = "req_xfer_end"        # payload delivered
REQ_COMPLETE = "req_complete"

EVENTS = (REQ_ACTIVATE, REQ_MATCH_UNEX, MSG_UNEX_INSERT,
          REQ_XFER_BEGIN, REQ_XFER_END, REQ_COMPLETE)

_subscribers: Dict[int, Dict[str, List[Callable]]] = {}


def subscribe(comm, event: str, fn: Callable) -> None:
    """fn(event, **info) is called at each occurrence on this comm."""
    if event not in EVENTS:
        raise ValueError(f"unknown PERUSE event {event!r}")
    _subscribers.setdefault(comm.cid, {}).setdefault(event, []).append(fn)


def unsubscribe_all(comm) -> None:
    _subscribers.pop(comm.cid, None)


def fire(comm, event: str, **info) -> None:
    if _obs.enabled:
        # PERUSE and the journal are one stream: every fired event is
        # also an instant span (nbytes carries the event's element
        # count, as fired)
        dst = info.get("dst")
        _obs.record(event, "peruse", _time.perf_counter(), 0.0,
                    nbytes=int(info.get("count", 0) or 0),
                    peer=dst if isinstance(dst, int) else -1,
                    comm_id=comm.cid)
    subs = _subscribers.get(comm.cid)
    if not subs:
        return
    for fn in subs.get(event, ()):
        fn(event, **info)


def has_subscribers(comm) -> bool:
    return bool(_subscribers.get(comm.cid))
