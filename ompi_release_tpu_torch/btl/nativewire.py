"""btl/nativewire — the zero-copy native datapath (``btl/sm`` +
``btl/tcp`` writev roles, played by the C sources under ``native/``);
the port's counterpart of ``ompi_release_tpu/btl/nativewire.py``.

One component, two transports, selected per peer from the modex
business cards exactly like :meth:`WireRouter._btl_for`:

* **co-hosted peers** ride a shared-memory SPSC byte ring
  (``native/btl_shm.cc``): the sender's ``writev`` gathers the
  precomposed SGH2 fragment parts straight into the mapped ring, the
  receiver's ``read_frag`` memcpys each fragment payload directly into
  the preallocated reassembly buffer — no Python-side copy on the byte
  path, and no shm segment created per payload (the ``ShmBtl`` handoff
  this replaces for capable peers).
* **cross-host peers** ride vectored socket IO over the existing OOB
  mesh (``native/btl_tcp.cc``): ``wire_sendv`` writev's the frame
  header plus scatter-gather parts in one syscall (byte-identical on
  the wire to ``ep.send(dst, tag, b"".join(parts))``), and
  ``wire_recv_frag`` lands queued SGC2 payloads straight into the
  reassembly buffer.

The SGH2 framing is BYTE-IDENTICAL to the portable staged path
(:class:`~.components.FrameTemplate` is the single framing authority;
``b"".join`` of each scatter-gather list reproduces the staged frame
bit for bit), and header frames ALWAYS ride the portable OOB send, so
any-source header peeks are untouched. Only fragment payloads leave
Python.

Host staging: the wire carries host bytes, by design of every port
transport (``btl/components.py``). A payload that is a tensor on the
card is copied to the host with one blocking copy before its fragments
are gathered — counted in ``wire_native_device_staged_bytes``, not as a
forced copy; the hier collectives hand this module host arrays
already, so their payloads move with no copy at all.
``wire_native_fallback_copies`` counts only the copies the fast path
was forced into beyond that design (a non-contiguous source compacted,
a ring record of another tag restashed). A received payload is rebuilt
as a host tensor, moved to ``dst_device`` when the caller names one.

One leg per transfer: a co-hosted transfer whose fragment records fit
the receiver's ring rides the ring whole, any other the socket whole —
both ends decide it from the header's chunk size and the receiver's
card, so each (peer, tag) stream keeps its FIFO order on one leg. A
ring only drains while its consumer reads it, and two processes that
post a round's sends before reaping it (every exchange of the hier
schedules) fill each other's rings: a sender facing a full ring pops
what waits in its own receive rings into their stashes (the records
stay in order; the receive loop reads the stash first) until its
record fits, as the C executor reaps its arrivals between sends.
Those copies are counted in ``wire_native_reaped_bytes``.

Graceful degradation is structural: the component withdraws from MCA
selection (``query`` -> None) when the native library lacks the
``wire_*``/``shmring_*`` symbols, when ``btl_nativewire_enable``/
``OMPITPU_NATIVEWIRE=0`` turns it off, or — per peer — when the
peer's modex card does not advertise the capability. Every fallback
lands on the portable staged-frames path, which this module can also
SPEAK (legacy SGH1, portable SGH2) because it subclasses
:class:`~.components.DcnBtl`.

Rings are released when their module is collected or at exit (a
``weakref.finalize``, never a strong ``atexit`` reference). The
telemetry lock the release takes is re-entrant: a garbage collection
that runs a module's release while another ring is being registered on
the same thread (the lock held) re-enters it instead of deadlocking.

Observability: ``btl_nativewire_events`` maps one per-process native
event ring (``obs/nativeev.py``) the C transports append a 32-byte
record to per fragment; the stall watchdog arms around a full-ring
send, an empty-ring receive and a ring attach; the ``native_rings``
postmortem contributor names every live ring, its peer pids and
occupancy; and with obs on a native transfer is one ``btl``-layer
span per side.
"""

from __future__ import annotations

import atexit
import os
import threading
import time as _time
import uuid
import weakref
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import obs as _obs
from ..mca import component as mca_component
from ..mca import pvar as _pvar
from ..mca import var as mca_var
from ..obs import watchdog as _watchdog
from ..utils.errors import ErrorCode, MPIError
from . import base
from . import components as _c
from .components import (
    _CHUNK2_MAGIC, _HDR2_MAGIC, _check_user_tag, _frags_inflight,
    _template_for, _unpack_array_header, _zero_copy_strict, DcnBtl,
    host_tensor, storage_dtype, stashed_recv, BF16,
)

#: modex business-card key: ``"token:slots:ring_bytes"`` — the
#: receiver-side ring geometry plus a per-process token namespacing
#: its /dev/shm ring names (a restarted replacement process gets a
#: fresh token, so stale rings can never be re-attached)
CARD_KEY = "nativewire"

_RING_SLOTS_DEFAULT = 4
_EVENT_SLOTS_DEFAULT = 1 << 16   # 2 MiB of 32-byte records
_RING_BYTES_DEFAULT = 8 * 1024 * 1024
#: a ring record's bytes beyond its fragment payload: the ring's
#: u32 length + i32 tag, then the SGC2 prefix (magic, xfer, index)
_RING_RECORD_OVERHEAD = 8 + 20
#: how long a fragment may wait on a full tx ring whose consumer reads
#: nothing before the send fails (the reference's bound)
_SEND_TIMEOUT_MS = 30_000
#: exit-time grace for tx rings holding bytes no consumer mapped yet —
#: covers a receiver still inside interpreter startup, not a hang
_DRAIN_TIMEOUT_MS = 10_000

#: native-datapath ledger: bytes/frames that crossed through the
#: native wire, and the honesty witness for the zero-copy claim —
#: every host-side materialization the fast path was FORCED into
#: (non-contiguous source compaction, ring cross-tag restash) counts,
#: so ``wire_native_copies_per_mib`` near 0 is evidence, not
#: advertising; the designed staging of a card tensor has its own
#: byte counter.
_native_bytes = _pvar.counter(
    "wire_native_bytes",
    "payload bytes moved by the nativewire datapath (shm-ring writev "
    "+ vectored socket writev + native fragment reassembly)",
)
_native_frames = _pvar.counter(
    "wire_native_frames",
    "SGC2 fragment frames moved by the nativewire datapath",
)
_fallback_copies = _pvar.counter(
    "wire_native_fallback_copies",
    "host-side byte materializations the native path was forced "
    "into: non-contiguous source compaction, ring cross-tag restash",
)
_reaped_bytes = _pvar.counter(
    "wire_native_reaped_bytes",
    "ring record bytes a sender popped out of its own receive rings "
    "into their stashes while its send ring was full (one host copy "
    "each: two co-hosted processes sending to each other at once "
    "drain each other's rings this way instead of both waiting)",
)
_device_staged = _pvar.counter(
    "wire_native_device_staged_bytes",
    "payload bytes of card tensors staged to the host (one blocking "
    "copy each) before the native datapath gathered them",
)
_copies_per_mib = _pvar.PVARS.register(
    "wire_native_copies_per_mib", _pvar.PvarClass.LEVEL,
    "forced host copies per MiB of native wire traffic (the zero-copy "
    "witness: ~0 when the byte path truly bypasses Python)",
    getter=lambda: (_fallback_copies.read()
                    / max(1.0, _native_bytes.read() / float(1 << 20))),
)

# ---------------------------------------------------------------------------
# C-side telemetry fold: the counters block lives IN the ring headers
# (native/btl_shm.cc) and the tcp endpoint struct (native/oob_endpoint.h)
# — relaxed single-writer u64s the transports bump on every
# writev/read_frag. Python never touches them on the byte path; these
# getter pvars fold the live blocks on READ.
# ---------------------------------------------------------------------------

#: re-entrant: a module's release (a weakref finalizer, run by a GC
#: that may fire inside _track_ring on this thread) takes it too
_tele_lock = threading.RLock()
#: live producer-side rings: their w_* counters are THIS process's work
_live_tx: set = set()
#: live consumer-side rings: the r_* half is ours
_live_rx: set = set()
#: endpoints that carried native frames (tcp-leg wire_stats source);
#: weak — an endpoint's lifetime belongs to the OOB layer
_seen_eps: "weakref.WeakSet" = weakref.WeakSet()
#: [stalls, stall_ns] folded out of rings at retire time, so closing
#: a ring never makes the process counters go backwards
_retired = [0, 0]
#: monotonic floor for the fold (a GC'd endpoint drops its share;
#: counters still must never decrease between two reads)
_mono = [0, 0]


def _track_ring(ring, tx: bool) -> None:
    if ring is None:
        return
    with _tele_lock:
        (_live_tx if tx else _live_rx).add(ring)


def _retire_ring(ring, tx: bool) -> None:
    """Fold a closing ring's final stall totals into the retired base
    and drop it from the live set (stats() reads shared memory — it
    must run BEFORE close unmaps)."""
    if ring is None:
        return
    try:
        st = ring.stats()
    except Exception:
        st = None
    with _tele_lock:
        (_live_tx if tx else _live_rx).discard(ring)
        if st is not None:
            pre = "w_" if tx else "r_"
            _retired[0] += int(st.get(pre + "stalls", 0))
            _retired[1] += int(st.get(pre + "stall_ns", 0))


def _track_ep(ep) -> None:
    try:
        _seen_eps.add(ep)
    except TypeError:
        pass  # non-weakrefable test double: no tcp stats to fold


def _stall_fold() -> Tuple[int, int]:
    """(stalls, stall_ns) this process has spent blocked on the native
    datapath: full-ring waits on tx rings, empty-ring waits on rx
    rings, queue-cv waits on tcp endpoints, plus the retired base."""
    with _tele_lock:
        rings = ([(r, "w_") for r in _live_tx]
                 + [(r, "r_") for r in _live_rx])
        eps = list(_seen_eps)
        stalls, ns = _retired[0], _retired[1]
    for ring, pre in rings:
        try:
            st = ring.stats()
        except Exception:
            continue
        stalls += int(st.get(pre + "stalls", 0))
        ns += int(st.get(pre + "stall_ns", 0))
    for ep in eps:
        try:
            ws = ep.wire_stats()
        except Exception:
            continue
        stalls += int(ws.get("rx_stalls", 0))
        ns += int(ws.get("rx_stall_ns", 0))
    with _tele_lock:
        _mono[0] = stalls = max(_mono[0], stalls)
        _mono[1] = ns = max(_mono[1], ns)
    return stalls, ns


def _hwm_fold() -> float:
    """Worst occupancy high-water fraction across live rings (0.0 with
    no rings): how close the busiest ring ever came to backpressure."""
    with _tele_lock:
        rings = list(_live_tx) + list(_live_rx)
    frac = 0.0
    for ring in rings:
        try:
            cap = float(ring.capacity)
            if cap > 0:
                frac = max(frac, float(ring.stats().get("hwm", 0)) / cap)
        except Exception:
            continue
    return min(1.0, frac)


_ring_stalls_pvar = _pvar.PVARS.register(
    "wire_native_ring_stalls", _pvar.PvarClass.COUNTER,
    "times a native-datapath call sat blocked (full tx ring, empty rx "
    "ring, empty tcp frame queue) — folded on read from the C-side "
    "counter blocks, zero Python on the byte path",
    getter=lambda: _stall_fold()[0],
)
_stall_seconds_pvar = _pvar.PVARS.register(
    "wire_native_stall_seconds", _pvar.PvarClass.TIMER,
    "cumulative seconds the native datapath spent blocked waiting on "
    "a peer (the time complement of wire_native_ring_stalls)",
    getter=lambda: _stall_fold()[1] / 1e9,
)
_hwm_frac_pvar = _pvar.PVARS.register(
    "wire_native_ring_hwm_frac", _pvar.PvarClass.LEVEL,
    "worst shm-ring occupancy high-water mark as a fraction of ring "
    "capacity (1.0 = some ring completely filled; sustained highs "
    "mean the consumer is the bottleneck or rings are undersized)",
    getter=_hwm_fold,
)


def register_nativewire_vars() -> None:
    """The component's own cvars (its standard ``btl_nativewire_*``
    size/ranking vars come from :func:`base.register_module_vars`)."""
    mca_var.register(
        "btl_nativewire_enable", "bool", True,
        "Use the native zero-copy datapath (shm rings + vectored "
        "socket IO) for staged wire transfers when the native library "
        "provides it; off = the portable staged-frames path "
        "(OMPITPU_NATIVEWIRE=0 is the env spelling)",
    )
    mca_var.register(
        "btl_nativewire_ring_bytes", "size", _RING_BYTES_DEFAULT,
        "Capacity of each receive-side shared-memory ring (one ring "
        "per co-hosted sender per slot); fragments larger than a ring "
        "fall back to the vectored-socket loopback automatically",
    )
    mca_var.register(
        "btl_nativewire_ring_slots", "int", _RING_SLOTS_DEFAULT,
        "Shared-memory rings per co-hosted sender: wire channels hash "
        "across slots so independent lanes do not share one FIFO",
    )
    mca_var.register(
        "btl_nativewire_events", "bool", False,
        "Mmap one per-process native event ring (ompitpu-nativeev-v1) "
        "and have the C transports append a 32-byte record per SGC2 "
        "fragment (t_ns, tag, xfer, bytes, wait_ns; drop-oldest wrap); "
        "tpu-doctor expands dumps into wire-layer spans with paired "
        "flow ids. Off (default) = zero event-path work — the ring "
        "counter blocks stay on either way",
    )
    mca_var.register(
        "btl_nativewire_event_slots", "int", _EVENT_SLOTS_DEFAULT,
        "Record capacity of the native event ring (32 bytes each; a "
        "full ring overwrites its oldest records)",
    )


register_nativewire_vars()  # idempotent; read at modex + module bind


def nativewire_ready() -> bool:
    """Local capability: native symbols present AND not disabled.
    Never raises — a probe failure is just 'not available'."""
    if os.environ.get("OMPITPU_NATIVEWIRE", "1").strip().lower() in (
            "0", "false", "no", "off"):
        return False
    if not mca_var.get("btl_nativewire_enable", True):
        return False
    try:
        from ..native import wire_symbols_available

        return bool(wire_symbols_available())
    except Exception:
        return False


_token_lock = threading.Lock()
_token: Optional[str] = None


def _local_token() -> str:
    global _token
    with _token_lock:
        if _token is None:
            _token = f"{os.getpid():x}-{uuid.uuid4().hex[:8]}"
        return _token


_ev_lock = threading.Lock()
_ev_ring = None
_ev_tried = False


def _event_ring():
    """Lazily create + install the per-process native event ring when
    ``btl_nativewire_events`` turns it on (once per process, however
    many modules bind). The shm name is unlinked immediately after
    create — only this process's own mapping matters (records decode
    in-process at dump time), so nothing can leak in /dev/shm. The
    ring is handed to ``obs.nativeev`` so finalize dumps and watchdog
    postmortems read it without importing this module."""
    global _ev_ring, _ev_tried
    with _ev_lock:
        if _ev_tried:
            return _ev_ring
        _ev_tried = True
        if not mca_var.get("btl_nativewire_events", False):
            return None
        try:
            from ..native import NativeEventRing

            slots = int(mca_var.get("btl_nativewire_event_slots",
                                    _EVENT_SLOTS_DEFAULT)
                        or _EVENT_SLOTS_DEFAULT)
            name = f"/onwev-{_local_token()}"
            ring = NativeEventRing.create(name, max(64, slots))
            if ring is None:
                # leftover name from a crashed earlier run (the token
                # makes a LIVE collision impossible): clear and retry
                NativeEventRing.unlink(name)
                ring = NativeEventRing.create(name, max(64, slots))
            if ring is None:
                return None  # symbols absent or shm refused: stay off
            NativeEventRing.unlink(name)
            ring.install()
            from ..obs import nativeev as _nativeev

            _nativeev.set_ring(ring)
            _ev_ring = ring
            atexit.register(_uninstall_event_ring)
        except Exception:
            _ev_ring = None
        return _ev_ring


def _uninstall_event_ring() -> None:
    """Exit hook: detach the C emit sink before interpreter teardown
    starts unmapping things under it. The mapping itself stays (the
    obs finalize dump may still be reading records)."""
    with _ev_lock:
        ring = _ev_ring
    if ring is not None:
        try:
            ring.uninstall()
        except Exception:
            pass


def _reset_event_state_for_tests() -> None:
    global _ev_ring, _ev_tried
    from ..obs import nativeev as _nativeev

    with _ev_lock:
        if _ev_ring is not None:
            try:
                if _nativeev.get_ring() is _ev_ring:
                    _nativeev.set_ring(None)
                _ev_ring.uninstall()
                _ev_ring.close()
            except Exception:
                pass
        _ev_ring = None
        _ev_tried = False


def _ring_wait_info(ring, peer_pidx: int, direction: str) -> dict:
    """Watchdog payload for a blocked ring wait, resolved at DUMP
    time: which ring (the /onw name carries the owner token), which
    peer pid sits on the other end, which direction stalled, and the
    ring's live occupancy — everything a postmortem reader needs to
    tell 'consumer wedged' from 'producer never wrote'."""
    info = {"ring": getattr(ring, "name", "?"),
            "dir": direction, "peer_pidx": int(peer_pidx)}
    try:
        info["peer_pid"] = int(ring.consumer_pid() if direction == "send"
                               else ring.producer_pid())
        pending, cap = int(ring.pending()), int(ring.capacity)
        info["pending"] = pending
        info["capacity"] = cap
        info["occupancy"] = round(pending / max(1, cap), 4)
    except Exception:
        pass  # ring unmapped under us: name + direction still help
    return info


def modex_entry() -> Dict[str, str]:
    """This process's business-card advertisement (empty when the
    capability is absent — peers key their per-peer fallback on the
    key's presence, the add_procs reachability discipline)."""
    if not nativewire_ready():
        return {}
    slots = int(mca_var.get("btl_nativewire_ring_slots",
                            _RING_SLOTS_DEFAULT) or _RING_SLOTS_DEFAULT)
    ring = int(mca_var.get("btl_nativewire_ring_bytes",
                           _RING_BYTES_DEFAULT) or _RING_BYTES_DEFAULT)
    return {CARD_KEY: f"{_local_token()}:{max(1, slots)}:{ring}"}


def _parse_card(entry) -> Optional[Tuple[str, int, int]]:
    try:
        token, slots, ring = str(entry).split(":")
        return token, max(1, int(slots)), max(1 << 16, int(ring))
    except Exception:
        return None  # malformed advertisement = not capable


def module_for(cards, my_pidx: int) -> Optional["NativeWireBtl"]:
    """The wire router's transport instance: None when the native
    datapath cannot run here (portable paths take over wholesale)."""
    if not nativewire_ready():
        return None
    try:
        mod = NativeWireBtl()
        mod.bind(cards, int(my_pidx))
        return mod
    except Exception:
        return None


def _ring_name(token: str, src_pidx: int, slot: int, inc: int = 0) -> str:
    """The /dev/shm name of the ring src_pidx -> the card's owner: the
    owner's token namespaces it, so a leak check can find every ring a
    job made by the ``/onw-`` prefix. ``inc`` is the producer's
    incarnation (its card's ``incarnation``, set for a respawned
    worker): a replacement's rings get names of their own and never
    meet a ring its dead predecessor left."""
    src = f"{src_pidx}i{inc}" if inc else f"{src_pidx}"
    return f"/onw-{token}-{src}-{slot}"


def _slot_of(tag: int, slots: int) -> int:
    # wire p2p tags differ per lane only above bit 17 — fold the high
    # bits down so independent lanes hash to different rings instead
    # of re-coupling head-of-line behind one FIFO
    t = int(tag)
    return ((t >> 17) ^ (t >> 7) ^ t) % max(1, int(slots))


def _host_array(data) -> Tuple[np.ndarray, str, bool]:
    """``(contiguous host array, wire dtype name, forced copy)`` over
    ``data``'s bytes. A host array or host tensor is viewed without a
    copy where it is contiguous; a non-contiguous source is compacted
    (a FORCED copy); a tensor on the card is staged to the host with
    one blocking copy (the port's designed staging, counted in bytes
    by ``wire_native_device_staged_bytes``)."""
    if isinstance(data, torch.Tensor):
        t = data.detach()
        copied = not t.is_contiguous()
        if t.device.type != "cpu":
            _device_staged.add(t.numel() * t.element_size())
        t = t.to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16, \
                copied
        arr = t.numpy()
        return arr, str(arr.dtype), copied
    arr = np.asarray(data)
    out = np.ascontiguousarray(arr)
    copied = out is not arr and not np.may_share_memory(out, arr)
    return out, str(out.dtype), copied


def _retry_send(fn, what: str):
    """The wire router's first-contact backoff: a confirmed process
    failure is never retried."""
    last = None
    for attempt in range(5):
        try:
            return fn()
        except MPIError as e:
            if e.code == ErrorCode.ERR_PROC_FAILED:
                raise
            last = e
            _time.sleep(0.05 * (attempt + 1))
    raise MPIError(ErrorCode.ERR_UNREACH,
                   f"{what} failed after retries: {last}")


def _close_rings(tx: dict, rx: dict, guard) -> None:
    """Release every ring of one module (its finalizer, run when the
    module is collected or at exit). A tx ring still holding bytes
    that NO consumer has mapped yet is in-flight data the socket path
    would have parked in kernel buffers: unlinking now would lose a
    completed send to a receiver that merely hasn't reached its recv,
    so such rings get a bounded grace window to be attached (the
    attach stamps consumer_pid into the shared header and the mapping
    outlives our unlink); drained or consumed rings close at once."""
    from ..native import ShmRing

    with guard:
        tx_ents, rx_ents = list(tx.values()), list(rx.values())
        tx.clear()
        rx.clear()
    deadline = _time.monotonic() + _DRAIN_TIMEOUT_MS / 1000
    for (ring, lk) in tx_ents:
        if ring is not None:
            try:
                while (ring.pending() > 0 and ring.consumer_pid() == 0
                       and _time.monotonic() < deadline):
                    _time.sleep(0.001)
            except Exception:
                pass
            # a sender mid-write holds the ring's lock: unmapping under
            # it would be a use after free (a later write sees a closed
            # ring and raises instead)
            with lk:
                _retire_ring(ring, tx=True)
                ShmRing.unlink(ring.name)  # no-op if consumer unlinked
                ring.close()
    for ring, lk, _stash in rx_ents:
        with lk:
            _retire_ring(ring, tx=False)
            ring.close()


class NativeWireBtl(DcnBtl):
    """The native datapath module. Subclassing :class:`DcnBtl` is the
    point: every ``send_staged``/``recv_staged`` call site in the wire
    router works unchanged, and the portable framings (legacy SGH1,
    interpreted SGH2) remain speakable for per-peer fallback."""

    NAME = "nativewire"
    EAGER_LIMIT = 64 * 1024
    MAX_SEND_SIZE = 4 * 1024 * 1024
    LATENCY = 20                    # beats dcn: no per-frame Python join
    BANDWIDTH = 50_000
    EXCLUSIVITY = 0
    #: wire transport only — never a device-segment mover, so BML move
    #: lists (device routing) are untouched by this component
    SUPPORTS_MOVE = False

    def __init__(self) -> None:
        super().__init__()
        self.cards = []
        self.my_pidx = -1
        #: per-peer parse cache: pidx -> (raw card entry, parsed) —
        #: validated against the LIVE card string on every lookup
        self._caps: Dict[int, tuple] = {}
        #: (peer_pidx, peer_token, slot) -> (ring-or-None, lock)
        self._tx: Dict[Tuple[int, str, int], tuple] = {}
        #: (src_pidx, src_token, slot) -> (ring, lock, cross-tag stash)
        self._rx: Dict[Tuple[int, str, int], tuple] = {}
        self._ring_guard = threading.Lock()
        self._finalizer = weakref.finalize(
            self, _close_rings, self._tx, self._rx, self._ring_guard)

    def bind(self, cards, my_pidx: int) -> None:
        self.cards = cards
        self.my_pidx = int(my_pidx)
        self._caps = {}
        _event_ring()  # cvar-gated; no-op (and cheap) when off

    def _cap(self, pidx: int) -> Optional[Tuple[str, int, int]]:
        """LIVE capability of ``pidx`` from the shared cards list."""
        try:
            card = self.cards[pidx]
        except Exception:
            return None
        entry = card.get(CARD_KEY) if isinstance(card, dict) else None
        if entry is None:
            return None
        cached = self._caps.get(pidx)
        if cached is not None and cached[0] == entry:
            return cached[1]
        parsed = _parse_card(entry)
        self._caps[pidx] = (entry, parsed)
        return parsed

    # -- per-peer eligibility (the add_procs verdict) ---------------------
    def peer_capable(self, peer_pidx: int) -> bool:
        """Both-ended capability: the peer advertised the native
        datapath AND this process advertised it (ring mode needs the
        receiver's geometry from OUR card on the peer's side)."""
        return (peer_pidx != self.my_pidx
                and self._cap(peer_pidx) is not None
                and self._cap(self.my_pidx) is not None)

    def _inc(self, pidx: int) -> int:
        """The incarnation ``pidx``'s card advertises (0: the first)."""
        try:
            return int(self.cards[pidx].get("incarnation", 0) or 0)
        except Exception:
            return 0

    def _peer_gone(self, peer_pidx: int) -> bool:
        """Whether the peer is dead: the job epoch marks it failed, or
        its card's pid no longer exists (authoritative on one host)."""
        from ..ft import ulfm

        if peer_pidx in ulfm.STATE.failed:
            return True
        try:
            pid = int(self.cards[peer_pidx].get("pid", 0) or 0)
        except Exception:
            return False
        if not pid:
            return False
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        except PermissionError:
            pass  # alive under another uid
        return False

    def _same_host(self, peer_pidx: int) -> bool:
        try:
            mine = self.cards[self.my_pidx].get("host")
            return bool(mine) and mine == self.cards[peer_pidx].get("host")
        except Exception:
            return False

    # -- ring lifecycle ----------------------------------------------------
    def _tx_ring(self, peer_pidx: int, slot: int):
        """Producer-side ring for (me -> peer, slot), created lazily
        with the RECEIVER's advertised geometry. A create failure is a
        permanent per-ring fallback to the vectored socket path (the
        entry caches None), never an error."""
        token, _slots, ring_bytes = self._cap(peer_pidx)
        key = (peer_pidx, token, slot)
        with self._ring_guard:
            ent = self._tx.get(key)
            if ent is None:
                from ..native import ShmRing

                name = _ring_name(token, self.my_pidx, slot,
                                  self._inc(self.my_pidx))
                ring = ShmRing.create(name, ring_bytes, os.getpid())
                if ring is None:
                    # leftover name from a crashed earlier run: the
                    # token makes collisions with a LIVE ring impossible
                    ShmRing.unlink(name)
                    ring = ShmRing.create(name, ring_bytes, os.getpid())
                _track_ring(ring, tx=True)
                ent = self._tx[key] = (ring, threading.Lock())
            return ent

    def _rx_ring(self, src_pidx: int, slot: int, deadline: float):
        """Consumer-side attach for (src -> me, slot), retried until
        the producer's lazy create lands; the name is unlinked right
        after attach (the mapping lives on) so /dev/shm stays clean.
        A producer that died before creating surfaces as the typed
        ERR_PROC_FAILED — pid liveness is authoritative on one host."""
        name = _ring_name(self._cap(self.my_pidx)[0], src_pidx, slot,
                          self._inc(src_pidx))
        peer_pid = 0
        try:
            peer_pid = int(self.cards[src_pidx].get("pid", 0) or 0)
        except Exception:
            pass
        tok = None
        if _watchdog.enabled:
            tok = _watchdog.arm(
                "nw_ring_attach", peer=src_pidx,
                info=lambda n=name, p=peer_pid, s=src_pidx: {
                    "ring": n, "dir": "attach", "peer_pidx": int(s),
                    "peer_pid": int(p)})
        try:
            while True:
                ent = self._attach_rx(src_pidx, slot)
                if ent is not None:
                    return ent
                if peer_pid:
                    try:
                        os.kill(peer_pid, 0)
                    except ProcessLookupError:
                        raise MPIError(
                            ErrorCode.ERR_PROC_FAILED,
                            f"shm ring from process {src_pidx} never "
                            f"appeared and its producer (pid "
                            f"{peer_pid}) is gone — peer died "
                            "mid-transfer",
                        )
                    except PermissionError:
                        pass  # alive under another uid
                if _time.monotonic() >= deadline:
                    raise MPIError(
                        ErrorCode.ERR_PENDING,
                        f"timed out waiting for process {src_pidx}'s "
                        f"shm ring {name}",
                    )
                _time.sleep(0.0005)
        finally:
            if tok is not None:
                _watchdog.disarm(tok)

    def _attach_rx(self, src_pidx: int, slot: int):
        """The consumer-side entry for (src -> me, slot), attaching the
        ring once if the producer has made it; None if it has not."""
        src_cap = self._cap(src_pidx)
        key = (src_pidx, src_cap[0] if src_cap else "", slot)
        with self._ring_guard:
            ent = self._rx.get(key)
        if ent is not None:
            return ent
        from ..native import ShmRing

        name = _ring_name(self._cap(self.my_pidx)[0], src_pidx, slot,
                          self._inc(src_pidx))
        ring = ShmRing.attach(name, os.getpid())
        if ring is None:
            return None
        ShmRing.unlink(name)
        with self._ring_guard:
            ent = self._rx.get(key)
            if ent is None:
                _track_ring(ring, tx=False)
                ent = self._rx[key] = (ring, threading.Lock(), {})
            else:
                ring.close()  # benign double-attach race
        return ent

    def _ring_leg(self, peer_pidx: int, ring_owner: int,
                  chunk: int) -> bool:
        """Whether a transfer between this process and the co-hosted
        ``peer_pidx`` rides the ring: its full-size fragment record
        fits the ring, whose size the receiver ``ring_owner``'s card
        sets. Sender and receiver compute the same answer."""
        return (self._same_host(peer_pidx)
                and _RING_RECORD_OVERHEAD + int(chunk)
                <= self._cap(ring_owner)[2])

    def _reap_rx(self) -> None:
        """Pop every record waiting in this process's receive rings
        into their stashes, attaching the rings co-hosted peers made
        since. A ring whose lock another thread holds is being read
        already and is skipped."""
        slots = self._cap(self.my_pidx)[1]
        guess = max(0, self.pipeline_segsize()) + _RING_RECORD_OVERHEAD
        for p in range(len(self.cards)):
            if not (self.peer_capable(p) and self._same_host(p)):
                continue
            for slot in range(slots):
                ent = self._attach_rx(p, slot)
                if ent is None:
                    continue
                ring, rlk, rstash = ent
                if not rlk.acquire(blocking=False):
                    continue
                try:
                    while ring.pending() > 0:
                        got = self._pop_other_locked(ring, guess)
                        if got is None:
                            break
                        rlen, rtag, raw = got
                        rstash.setdefault(rtag, []).append(raw)
                        _reaped_bytes.add(rlen)
                finally:
                    rlk.release()

    def plan_endpoints(self, tag: int, send_peers, recv_srcs):
        """Per-peer native handles for a frozen-plan executor
        (coll/native_exec): ``{pidx: (tx, rx)}`` where tx is the
        producer-side ``(ring, lock)`` toward the peer (None =
        cross-host or ring creation failed → the executor uses the
        vectored-socket leg, exactly like the interpreted path) and
        rx is the consumer-side ``(ring, lock, cross-tag stash)``
        entry for frames FROM the peer (None = cross-host). The
        executor holds both locks for the whole fire — the rings are
        SPSC, so concurrent Python senders/receivers must stay out
        precisely as long as C owns the cursors."""
        out = {}
        for p in sorted(set(send_peers) | set(recv_srcs)):
            tx = rx = None
            if self._same_host(p):
                if p in send_peers:
                    ent = self._tx_ring(
                        p, _slot_of(tag, self._cap(p)[1]))
                    if ent[0] is not None:
                        tx = ent
                if p in recv_srcs:
                    slot = _slot_of(tag, self._cap(self.my_pidx)[1])
                    rx = self._rx_ring(p, slot,
                                       _time.monotonic() + 5.0)
            out[p] = (tx, rx)
        return out

    def _shutdown_rings(self) -> None:
        """Release every ring now (the finalizer, run early)."""
        self._finalizer()

    # -- send side ---------------------------------------------------------
    def _ring_put(self, ring, lk, peer_pidx: int, tag: int,
                  parts) -> None:
        """Write one fragment record into the tx ring. While the ring
        is full, reap this process's own receive rings (see the module
        docstring): the peer may be waiting on a ring toward us; and
        every ~100 ms check that the peer lives, so a sender parked on
        a ring toward a dead peer stops with ERR_PROC_FAILED, and that
        a collective channel's communicator is not revoked: a live
        peer that left the collective to recover from a third
        process's failure stops draining, and revokes the comm."""
        from ..runtime.wire import WIRE_COLL_BASE

        cid = tag - WIRE_COLL_BASE
        cid = cid if 0 <= cid < (1 << 20) else None
        deadline = _time.monotonic() + _SEND_TIMEOUT_MS / 1000
        next_check = _time.monotonic() + 0.1
        tok = None
        if _watchdog.enabled:
            # a full-ring wait spins here; the zero-arg info resolves
            # at dump time, so the postmortem names the ring, its
            # consumer, and the LIVE occupancy when the watchdog fired
            tok = _watchdog.arm(
                "nw_ring_put", peer=peer_pidx,
                info=lambda r=ring, p=peer_pidx: _ring_wait_info(
                    r, p, "send"))
        try:
            while True:
                with lk:
                    rc = ring.writev(tag, parts, 1)
                if rc == 0:
                    return
                if rc == -3:
                    raise MPIError(
                        ErrorCode.ERR_PROC_FAILED,
                        f"shm ring to process {peer_pidx} reports "
                        "its consumer dead — peer died mid-transfer",
                    )
                if rc != -1:
                    raise MPIError(
                        ErrorCode.ERR_INTERN,
                        f"shm ring to process {peer_pidx} refused a "
                        f"fragment record (rc {rc})",
                    )
                now = _time.monotonic()
                if now >= next_check:
                    next_check = now + 0.1
                    if cid is not None:
                        from ..ft import ulfm

                        ulfm.STATE.check_wait(
                            cid, (), f"collective send to process "
                                     f"{peer_pidx} (ring full)")
                    if self._peer_gone(peer_pidx):
                        raise MPIError(
                            ErrorCode.ERR_PROC_FAILED,
                            f"shm ring to process {peer_pidx} stayed full "
                            "and its consumer is dead — peer died "
                            "mid-transfer",
                        )
                if now >= deadline:
                    raise MPIError(
                        ErrorCode.ERR_PENDING,
                        f"shm ring to process {peer_pidx} stayed full for "
                        f"{_SEND_TIMEOUT_MS} ms (consumer stalled)",
                    )
                self._reap_rx()
        finally:
            if tok is not None:
                _watchdog.disarm(tok)

    def frame_stream(self, oob_ep, peer_pidx: int, tag: int, data,
                     tpl=None):
        """Side-effecting generator, one wire frame per ``next()`` —
        the native twin of the router's planned/staged frame streams,
        so the in-flight window discipline applies to native transfers
        unchanged. The header frame rides the portable OOB send
        (any-source peeks depend on seeing it there); fragments ride
        the ring or the vectored socket as scatter-gather part lists."""
        _check_user_tag(tag)
        nid = peer_pidx + 1
        seg = self.pipeline_segsize()
        if not self.peer_capable(peer_pidx) or seg <= 0:
            # portable framing end-to-end (legacy SGH1 when seg==0)
            _retry_send(
                lambda: DcnBtl.send_staged(self, oob_ep, nid, tag, data),
                f"staged transfer to process {peer_pidx}")
            yield
            return
        rec = _obs.enabled  # capture once: flag may flip mid-send
        t0 = _time.perf_counter() if rec else 0.0
        _track_ep(oob_ep)  # tcp-leg counters fold from its C struct
        arr, dname, copied = _host_array(data)
        if copied:
            _fallback_copies.add()
        if tpl is not None and not tpl.matches(arr, dname):
            raise MPIError(
                ErrorCode.ERR_INTERN,
                f"planned staged transfer: buffer {arr.shape}/"
                f"{dname} does not match the frozen frame template "
                f"{tpl.shape}/{tpl.dtype} — schedule diverged from its "
                "plan (rebuild the persistent request)",
            )
        if tpl is None:
            tpl = _template_for(arr.shape, dname, seg)
        mv = memoryview(arr.reshape(-1).view(np.uint8)) if arr.size \
            else memoryview(b"")
        xfer = next(_c._xfer_ids)
        frames = tpl.sg_lists(mv, xfer, zlib.crc32(mv))
        header = b"".join(next(frames))
        ring = lk = None
        if self._ring_leg(peer_pidx, peer_pidx, tpl.chunk):
            # ring exists BEFORE the header leaves: a receiver that
            # holds the header can always attach without waiting
            ring, lk = self._tx_ring(
                peer_pidx, _slot_of(tag, self._cap(peer_pidx)[1]))
        _retry_send(lambda: oob_ep.send(nid, tag, header),
                    f"native header to process {peer_pidx}")
        yield
        for parts in frames:
            plen = len(parts[-1])
            if ring is not None:
                self._ring_put(ring, lk, peer_pidx, tag, parts)
            else:
                _retry_send(
                    lambda p=parts: oob_ep.sendv(nid, tag, p),
                    f"native fragment to process {peer_pidx}")
            _zero_copy_strict.add(plen)
            _native_bytes.add(plen)
            _native_frames.add()
            self.staged_chunks_pvar.add()
            yield
        self.staged_bytes_pvar.add(tpl.nbytes)
        if rec and _obs.enabled:
            _obs.record("btl_nw_send", "btl", t0,
                        _time.perf_counter() - t0,
                        nbytes=int(tpl.nbytes), peer=peer_pidx)

    def send_staged(self, oob_ep, peer_nid: int, tag: int, data) -> int:
        n = 0
        for _ in self.frame_stream(oob_ep, peer_nid - 1, tag, data):
            n += 1
        return max(0, n - 1)  # header is not a chunk

    # -- receive side ------------------------------------------------------
    @staticmethod
    def _pop_stashed(oob_ep, src_nid: int, tag: int):
        from .components import _ep_stash

        stash, lock = _ep_stash(oob_ep)
        with lock:
            q = stash.get((src_nid, tag))
            if q:
                return q.pop(0)
        return None

    def recv_staged(self, oob_ep, tag: int, *, src=None,
                    dst_device=None, timeout_ms: int = 30_000,
                    first=None):
        """Native reassembly: the header is popped/parsed exactly like
        the portable path (shared stash, shared resync discipline);
        SGH2 fragments from a capable co-hosted sender then come out
        of the shm ring, from a capable cross-host sender out of the
        native frame queue — both memcpy'd straight into the
        preallocated buffer. Everything else (legacy SGH1, a sender
        that never advertised the capability) resumes the portable
        reassembly with the already-popped header. Returns a host
        tensor, or one on ``dst_device``."""
        from ..native import DssBuffer

        _check_user_tag(tag)
        rec = _obs.enabled  # capture once: flag may flip mid-recv
        t_obs = _time.perf_counter() if rec else 0.0
        deadline = _time.monotonic() + timeout_ms / 1000
        while True:
            if first is not None:
                src_got, hraw = first
                first = None
            else:
                src_got, hraw = stashed_recv(oob_ep, src, tag, deadline)
            try:
                hdr = DssBuffer(hraw)
                magic = hdr.unpack_string()
                if magic != _HDR2_MAGIC:
                    if magic == _c._HDR_MAGIC:
                        break  # legacy framing: portable reassembly
                    continue  # orphan chunk: resync to the next header
                (xfer,) = hdr.unpack_int64()
                dname, shape = _unpack_array_header(hdr)
                nchunks, chunk = hdr.unpack_int64(2)
                (crc,) = hdr.unpack_int64()
            except MPIError:
                continue  # a chunk frame: skip to the next header
            break
        src = src_got
        src_pidx = src - 1
        left_ms = max(1, int((deadline - _time.monotonic()) * 1000))
        if magic != _HDR2_MAGIC or not self.peer_capable(src_pidx):
            return DcnBtl.recv_staged(
                self, oob_ep, tag, src=src, dst_device=dst_device,
                timeout_ms=left_ms, first=(src, hraw))
        _track_ep(oob_ep)  # tcp-leg counters fold from its C struct
        dtype = storage_dtype(dname)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if nbytes < 0 or any(d < 0 for d in shape):
            raise MPIError(ErrorCode.ERR_TRUNCATE,
                           f"staged transfer {xfer}: malformed "
                           f"shape {shape}")
        buf = bytearray(nbytes)
        bmv = memoryview(buf)
        want = _CHUNK2_MAGIC + int(xfer).to_bytes(8, "big")
        _frags_inflight.set(int(nchunks))
        nchunks, chunk = int(nchunks), int(chunk)
        ring_ent = None
        if self._ring_leg(src_pidx, self.my_pidx, chunk):
            slot = _slot_of(tag, self._cap(self.my_pidx)[1])
            ring_ent = self._rx_ring(src_pidx, slot, deadline)

        def place(praw) -> bool:
            """One already-materialized frame (stash/cross-tag restash
            path): the portable placement + stale-drop discipline."""
            if not praw.startswith(want):
                return False  # stale frame from an abandoned transfer
            idx = int.from_bytes(praw[12:20], "big")
            payload = memoryview(praw)[20:]
            off = idx * chunk
            if idx >= nchunks or off + len(payload) > nbytes:
                raise MPIError(
                    ErrorCode.ERR_TRUNCATE,
                    f"staged transfer {xfer}: fragment {idx} overruns "
                    f"the {nbytes}-byte buffer",
                )
            bmv[off:off + len(payload)] = payload
            return True

        got = 0
        tok = None
        if ring_ent is not None and _watchdog.enabled:
            # the empty-ring wait blocks inside ring.read_frag (C
            # slices of <=200ms): name the ring, its producer, and the
            # live occupancy in any stall postmortem
            tok = _watchdog.arm(
                "nw_ring_recv", peer=src_pidx,
                info=lambda r=ring_ent[0], p=src_pidx: _ring_wait_info(
                    r, p, "recv"))
        try:
            while got < nchunks:
                # a ring-leg transfer has no frame on the socket: the
                # endpoint stash holds other transfers' frames then
                praw = (None if ring_ent is not None
                        else self._pop_stashed(oob_ep, src, tag))
                if praw is not None:
                    if place(praw):
                        got += 1
                        self.staged_chunks_pvar.add()
                    continue
                left_ms = int((deadline - _time.monotonic()) * 1000)
                if left_ms <= 0:
                    raise MPIError(
                        ErrorCode.ERR_PENDING,
                        f"native staged transfer {xfer} from process "
                        f"{src_pidx}: timed out with {got}/{nchunks} "
                        "fragments",
                    )
                step = min(left_ms, 200)
                if ring_ent is not None:
                    ring, rlk, rstash = ring_ent
                    restash = None
                    with rlk:
                        q = rstash.get(tag)
                        praw = q.pop(0) if q else None
                        if praw is None:
                            rc = ring.read_frag(tag, xfer, nchunks,
                                                chunk, buf, step)
                            if rc == -5:
                                restash = self._pop_other_locked(ring)
                    if praw is not None:
                        if place(praw):
                            got += 1
                            self.staged_chunks_pvar.add()
                        continue
                    if restash is not None:
                        _rlen, rtag, raw2 = restash
                        with rlk:
                            rstash.setdefault(rtag, []).append(raw2)
                        _fallback_copies.add()  # the one restash copy
                        continue
                    if rc >= 0:
                        got += 1
                        self.staged_chunks_pvar.add()
                        continue
                    if rc in (-1, -4, -5):
                        continue  # slice timeout / stale / raced
                    if rc == -3:
                        raise MPIError(
                            ErrorCode.ERR_PROC_FAILED,
                            f"shm ring from process {src_pidx} reports "
                            f"its producer dead with {got}/{nchunks} "
                            "fragments landed — peer died mid-transfer",
                        )
                    raise MPIError(
                        ErrorCode.ERR_TRUNCATE,
                        f"staged transfer {xfer}: malformed ring "
                        f"record (rc {rc})",
                    )
                rc = oob_ep.recv_frag(src, tag, xfer, nchunks, chunk, buf,
                                      step)
                if rc >= 0:
                    got += 1
                    self.staged_chunks_pvar.add()
                    continue
                if rc == -1:
                    continue  # slice timeout: re-check deadline
                if rc == -4:
                    # the queue head for (src, tag) is not ours: pop it
                    # through the shared stash machinery and apply the
                    # portable stale-drop filter
                    try:
                        _, raw2 = stashed_recv(oob_ep, src, tag,
                                               _time.monotonic() + 0.05)
                    except MPIError:
                        continue
                    if place(raw2):
                        got += 1
                        self.staged_chunks_pvar.add()
                    continue
                raise MPIError(
                    ErrorCode.ERR_TRUNCATE,
                    f"staged transfer {xfer}: fragment overruns "
                    f"the {nbytes}-byte buffer (native rc {rc})",
                )
        finally:
            if tok is not None:
                _watchdog.disarm(tok)
        if zlib.crc32(bmv) != int(crc):
            raise MPIError(
                ErrorCode.ERR_TRUNCATE,
                f"staged transfer {xfer} failed its payload CRC — "
                "wire corruption or interleaved frames",
            )
        _zero_copy_strict.add(nbytes)
        _native_bytes.add(nbytes)
        arr = np.frombuffer(buf, dtype=dtype).reshape(shape)
        self.staged_bytes_pvar.add(arr.nbytes)
        if rec and _obs.enabled:
            _obs.record("btl_nw_recv", "btl", t_obs,
                        _time.perf_counter() - t_obs,
                        nbytes=int(arr.nbytes), peer=src_pidx)
        return host_tensor(arr, dname, dst_device)

    @staticmethod
    def _pop_other_locked(ring, size: int = 1 << 16):
        """Pop the ring head while the caller holds the ring lock;
        returns (len, tag, record bytes) or None when the head raced
        away / cannot be materialized. ``size`` is the first guess at
        the record's length; the buffer grows until it fits and is
        then cut to the record, which is returned without a copy."""
        size = max(1, min(int(size), ring.capacity))
        while True:
            tmp = bytearray(size)
            rc, rtag = ring.read_into(tmp, 10)
            if rc == -2:
                if size >= ring.capacity:
                    return None
                size = min(size * 8, ring.capacity)
                continue
            if rc < 0:  # -1 raced-empty / -3 dead: main loop handles
                return None
            del tmp[rc:]
            return rc, rtag, tmp


class NativeWireComponent(mca_component.Component):
    """MCA shell: withdraws (``query`` -> None) whenever the local
    capability is absent, so BML selection and the fallback contract
    are decided by the standard component machinery."""

    NAME = "nativewire"
    PRIORITY = 45  # between shm (50) and dcn (40): preferred wire path

    def register_vars(self) -> None:
        base.register_module_vars(NativeWireBtl)
        register_nativewire_vars()

    def query(self, ctx=None):
        if not nativewire_ready():
            return None
        return (self.priority, NativeWireBtl())


base.BTL_FRAMEWORK.register(NativeWireComponent())


def _native_rings() -> dict:
    """Watchdog-postmortem contributor: every live native ring's
    identity, endpoints, occupancy, and counter block — whatever rank
    is stalled, the postmortem shows which ring sat full/empty and
    which pid was supposed to drain/fill it."""
    with _tele_lock:
        tx = list(_live_tx)
        rx = list(_live_rx)
        retired = (_retired[0], _retired[1])

    def row(ring) -> dict:
        try:
            return {"name": ring.name, "capacity": int(ring.capacity),
                    "pending": int(ring.pending()),
                    "producer_pid": int(ring.producer_pid()),
                    "consumer_pid": int(ring.consumer_pid()),
                    "stats": ring.stats()}
        except Exception:
            return {"name": getattr(ring, "name", "?")}

    return {"tx": [row(r) for r in tx], "rx": [row(r) for r in rx],
            "retired_stalls": retired[0],
            "retired_stall_ns": retired[1]}


_watchdog.add_contributor("native_rings", _native_rings)
