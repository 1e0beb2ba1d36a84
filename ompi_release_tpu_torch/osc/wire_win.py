"""Cross-process one-sided communication — home-process-applies RMA.

Counterpart of ``ompi_release_tpu/osc/wire_win.py``. The reference's osc
framework moves RMA data between any two ranks over the BTLs
(``ompi/mca/osc/rdma/osc_rdma_data_move.c``; ``osc/pt2pt`` ships ops as
active messages where no RDMA path exists). Under the unified ``tpurun``
world each worker owns only its LOCAL members' window slices, so an RMA
op whose target lives in another process is SHIPPED to that process (the
target's *home*) at synchronization time:

- an epoch close partitions the pending queue by target owner; local ops
  close through the access-plan cache (``osc/plan.py``: on the card a
  seen signature replays its CUDA graph), remote ops serialize into one
  batch per owner process (a seen batch signature renders through its
  frozen :class:`~.plan.BatchTemplate`);
- the owner's *window service thread* applies an incoming batch into its
  local slices through the same access-plan cache, on the window's
  device and a stream of its own, holding ``coll/plan.capture_lock``
  for every launch (an app thread's capture must never record the
  service's launches, nor the reverse), and replies with the pre-op
  values of the batch's reads plus a completion ack, which gives
  ``flush`` its remote-completion meaning;
- passive target is real: the lock state for a target rank lives at the
  target's OWNER process (a service-side lock table with waiter queues),
  so origins in different processes contending for an exclusive lock
  serialize without the target's application code taking part.

Replies are demultiplexed by token: every outstanding request registers
a slot, one thread at a time pumps the shared reply channel and routes
each reply (and its read payload) to its slot, and no lock is held
across a reply wait, so a thread waiting for a deferred lock grant never
blocks the thread whose unlock produces that grant.

Frames are ``np.savez``-style zips written with a fixed timestamp
(:func:`_savez_bytes`) and read with ``np.load(allow_pickle=False)``
over the wire's payload transports, inside a ``DssBuffer`` envelope: no
pickle. They are byte-identical to the JAX package's frames for the same
ops. A bf16 payload is written as its raw 2-byte words under the header
``'descr': '<V2'`` (the bytes ``np.save`` writes for an ``ml_dtypes``
bfloat16 array), and a 2-byte void array read off the wire is taken as
bf16 words. (The JAX package's home cannot apply such a batch: a void
array is no JAX type, so its cross-process bf16 RMA fails at the home.)
Only predefined reduction ops may cross a process boundary (MPI
restricts MPI_Accumulate to predefined ops).

Payloads: a payload bound for another process is copied to the host when
the op is queued; an arriving batch moves to the window's device before
it is applied; reads come back as host tensors, each a copy.

Observability: with obs on, a request is a ``win_request`` span and
its application at the home a ``win_apply`` span, both carrying the
``("win", origin process, token)`` flow id the envelope already holds;
the stall watchdog arms around a request's reply wait, a PSCW notice
wait and a local lock wait; and the flight recorder's ``window_locks``
contributor dumps every service's lock table.
"""

from __future__ import annotations

import io
import itertools
import json
import threading
import time
import weakref
import zipfile
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs as _obs
from ..btl.components import payload_nbytes
from ..coll.plan import capture_lock
from ..mca import pvar
from ..mca import var as mca_var
from ..native import DssBuffer
from ..obs import watchdog as _watchdog
from ..ops.op import PREDEFINED_OPS
from ..request.request import Request, Status
# the router's module registers wire_coll_timeout_ms, which OscTuning reads
from ..runtime.wire import proc_topology
from ..utils import output
from ..utils.arrays import copy_to
from ..utils.errors import ErrorCode, MPIError
from .window import (LOCK_EXCLUSIVE, LOCK_SHARED, Window, _EpochKind,
                     _PendingOp)

_log = output.stream("osc")


def register_vars() -> None:
    mca_var.register(
        "osc_request_timeout_ms", "int", 120_000,
        "Bound in milliseconds on window-service request/reply waits "
        "(batches, lock grants — a grant may legitimately be deferred "
        "behind another holder, hence the generous default). The "
        "effective bound also honors wire_coll_timeout_ms when that is "
        "set higher",
    )
    mca_var.register(
        "osc_abandon_timeout_ms", "int", 10_000,
        "Bound in milliseconds on the best-effort lock-abandon notice "
        "after a timed-out acquire (the home may be unreachable)",
    )
    mca_var.register(
        "osc_pscw_timeout_s", "float", 0.0,
        "Bound in seconds on PSCW start()/wait() notice waits; 0 = "
        "unbounded (MPI's rule — the partner may compute arbitrarily "
        "long before complete()); set it to turn a hung partner into a "
        "diagnosable error",
    )


register_vars()


class OscTuning:
    """One immutable snapshot of the window service's hot-path cvars,
    re-resolved only when the MCA write generation moves: RMA steady
    state never touches the registry."""

    __slots__ = ("gen", "request_timeout_ms", "abandon_timeout_ms",
                 "pscw_timeout_s")

    def __init__(self) -> None:
        self.gen = mca_var.VARS.generation
        req = int(mca_var.get("osc_request_timeout_ms", 120_000)
                  or 120_000)
        wire = int(mca_var.get("wire_coll_timeout_ms", 60_000) or 60_000)
        # an operator-raised collective wait bound must not be undercut
        # by the RMA default: a deferred lock grant can wait behind a
        # holder as long as any collective may block
        self.request_timeout_ms = max(req, wire)
        self.abandon_timeout_ms = int(
            mca_var.get("osc_abandon_timeout_ms", 10_000) or 10_000)
        self.pscw_timeout_s = float(
            mca_var.get("osc_pscw_timeout_s", 0) or 0)


_win_requests = pvar.counter(
    "osc_wire_requests",
    "cross-process window service requests (batch/lock/abandon)",
)
#: the spans of a remote request, origin side and home side: a request's
#: round trip less its home's batch time is the time in flight (the
#: wire both ways and each side's pickup of the frame)
_t_pack = pvar.timer("osc_wire_pack_seconds",
                     "origin: rendering batch payloads")
_t_request = pvar.timer("osc_wire_request_seconds",
                        "origin: request sent to reply routed")
_t_home = pvar.timer("osc_wire_home_batch_seconds",
                     "home: a batch from its envelope to its reply sent")
_t_recv = pvar.timer("osc_wire_home_recv_seconds",
                     "home: receiving a batch's payload")
_t_unpack = pvar.timer("osc_wire_home_unpack_seconds",
                       "home: loading a batch's payload into ops")
_t_apply = pvar.timer("osc_wire_home_apply_seconds",
                      "home: applying a batch (device moves, the epoch "
                      "close, the drain)")
_t_wait = pvar.timer("osc_wire_home_wait_seconds",
                     "home: waiting for the window's op lock and, on "
                     "the card, the capture lock")
_t_close = pvar.timer("osc_wire_home_close_seconds",
                      "home: the batch's epoch close (plan or graph)")
_t_drain = pvar.timer("osc_wire_home_drain_seconds",
                      "home on the card: stream drain and reads to host")
_t_reply = pvar.timer("osc_wire_reply_seconds",
                      "home: sending a reply and its reads")

#: live window services (one per runtime) for the flight recorder's
#: lock-table contributor — weak so a torn-down runtime's service
#: never pins memory or shows up in dumps
_services: "weakref.WeakSet" = weakref.WeakSet()


def _lock_tables_snapshot() -> List[Dict]:
    """Dump contributor: every live service's passive-target lock
    table + outstanding reply slots (who holds what, who waits).
    Lock acquisition is BOUNDED: the recorder dumps because something
    is hung, possibly a thread wedged inside these very critical
    sections — blocking here would hang the flight recorder itself
    (and, via _dump_lock, every later dump)."""
    out = []
    for svc in list(_services):
        entry: Dict = {"pidx": svc.my_pidx}
        if svc._state_lock.acquire(timeout=0.5):
            try:
                entry["locks"] = [
                    {"cid": k[0], "win_seq": k[1], "target": k[2],
                     "mode": st.mode, "holders": sorted(st.holders),
                     "waiters": [{"origin": w[0], "type": w[1],
                                  "local": w[2] is not None}
                                 for w in st.waiters]}
                    for k, st in svc._locks.items()
                ]
            finally:
                svc._state_lock.release()
        else:
            entry["locks"] = "unavailable: state lock held (a thread " \
                             "is wedged inside the lock table)"
        if svc._reply_guard.acquire(timeout=0.5):
            try:
                entry["outstanding_requests"] = len(svc._reply_slots)
            finally:
                svc._reply_guard.release()
        else:
            entry["outstanding_requests"] = "unavailable: reply guard held"
        out.append(entry)
    return out


_watchdog.add_contributor("window_locks", _lock_tables_snapshot)

#: window-service envelopes (any-source); payloads ride the three
#: sibling channels so an any-source envelope pop can never swallow
#: another sender's payload frame
WIRE_WIN_SERVICE = 5 << 20
WIRE_WIN_DATA = 6 << 20
WIRE_WIN_REPLY = 7 << 20
WIRE_WIN_RDATA = 8 << 20

_WIN_MAGIC = "WWIN"

KIND_BATCH = 1    # arg1 = release_target comm rank (or -1)
KIND_LOCK = 2     # arg1 = target, arg2 = lock type
KIND_ABANDON = 3  # arg1 = target: forget this origin's lock interest
KIND_POST = 4     # one-way: src process posted an exposure epoch
KIND_COMPLETE = 5  # one-way: src process completed its access epoch
KIND_ERROR = 99   # home-side failure applying a request

#: the .npy header descr of a bf16 payload (what ``np.save`` writes for
#: an ml_dtypes bfloat16 array): its raw words as a 2-byte void
_BF16_DESCR = "<V2"


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

def _wire_array(x) -> np.ndarray:
    """A payload or read as the numpy array its frame member holds: a
    tensor's host bytes (a bf16 tensor as its uint16 words viewed as a
    2-byte void, written under ``_BF16_DESCR``); numpy passes through."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    t = x.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    t = t.contiguous()
    if t.dtype is torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _write_member(fid, arr: np.ndarray) -> None:
    """One .npy member: ``np.lib.format.write_array``'s bytes, with a
    2-byte void (bf16 words) under ``_BF16_DESCR``."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2 \
            and arr.dtype.names is None:
        np.lib.format.write_array_header_1_0(
            fid, {"descr": _BF16_DESCR, "fortran_order": False,
                  "shape": arr.shape})
        fid.write(np.ascontiguousarray(arr).tobytes())
        return
    np.lib.format.write_array(fid, np.asanyarray(arr), allow_pickle=False)


def _savez_bytes(arrays: Dict[str, np.ndarray]) -> bytes:
    """Deterministic npz writer: ``np.savez`` stamps every zip member
    with the wall-clock mtime, so two packs of identical ops would
    differ; members here carry the DOS epoch, so a frozen frame
    template renders the interpreted pack's bytes, and ``np.load``
    reads the zip unchanged."""
    bio = io.BytesIO()
    with zipfile.ZipFile(bio, "w", zipfile.ZIP_STORED) as zf:
        for name, val in arrays.items():
            zi = zipfile.ZipInfo(name + ".npy",
                                 date_time=(1980, 1, 1, 0, 0, 0))
            with zf.open(zi, "w", force_zip64=True) as fid:
                _write_member(fid, val)
    return bio.getvalue()


def _tensor_of(arr: np.ndarray) -> torch.Tensor:
    """A host tensor holding a frame member (a 2-byte void = bf16
    words), sharing no memory with the frame."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(
            np.array(arr.view(np.int16))).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _batch_meta(todo: List[_PendingOp]) -> List[Dict]:
    """Per-op request records (the frame's metadata), shared by the
    per-call pack and osc/plan's frozen ``BatchTemplate`` so the two
    cannot drift. The predefined check is by IDENTITY, not name: a user
    op that merely shares a predefined op's name is refused, or the home
    would silently apply the predefined one."""
    meta = []
    for p in todo:
        if p.op is not None and PREDEFINED_OPS.get(p.op.name) is not p.op:
            raise MPIError(
                ErrorCode.ERR_OP,
                f"cross-process RMA requires a predefined op, got "
                f"'{p.op.name}' (MPI_Accumulate's own rule)",
            )
        meta.append({
            "k": p.kind,
            "t": int(p.target),
            "o": p.op.name if p.op is not None else "",
            "i": -1 if p.index is None else int(p.index),
            "r": p.request is not None,
        })
    return meta


def _meta_array(todo: List[_PendingOp]) -> np.ndarray:
    return np.frombuffer(json.dumps(_batch_meta(todo)).encode(),
                         dtype=np.uint8).copy()


def _pack_batch(todo: List[_PendingOp]) -> np.ndarray:
    """Serialize a pending-op batch to one uint8 array (npz form)."""
    meta = _meta_array(todo)
    arrays: Dict[str, np.ndarray] = {}
    for i, p in enumerate(todo):
        if p.data is not None:
            arrays[f"d{i}"] = _wire_array(p.data)
        if p.compare is not None:
            arrays[f"c{i}"] = _wire_array(p.compare)
    arrays["meta"] = meta
    return np.frombuffer(_savez_bytes(arrays), dtype=np.uint8)


def _load(raw) -> "np.lib.npyio.NpzFile":
    if isinstance(raw, torch.Tensor):
        raw = raw.numpy()
    return np.load(io.BytesIO(np.asarray(raw, dtype=np.uint8).tobytes()),
                   allow_pickle=False)


def _unpack_batch(raw) -> List[_PendingOp]:
    """Inverse of :func:`_pack_batch`: host-tensor payloads, and fresh
    local requests for the ops that want a read back."""
    z = _load(raw)
    meta = json.loads(bytes(z["meta"]).decode())
    todo = []
    for i, m in enumerate(meta):
        todo.append(_PendingOp(
            m["k"], m["t"],
            data=(_tensor_of(z[f"d{i}"]) if f"d{i}" in z else None),
            op=(PREDEFINED_OPS[m["o"]] if m["o"] else None),
            request=(Request() if m["r"] else None),
            compare=(_tensor_of(z[f"c{i}"]) if f"c{i}" in z else None),
            index=(None if m["i"] < 0 else m["i"]),
        ))
    return todo


def _pack_reads(values: List) -> np.ndarray:
    return np.frombuffer(
        _savez_bytes({f"r{i}": _wire_array(v)
                      for i, v in enumerate(values)}), dtype=np.uint8)


def _unpack_reads(raw, n: int) -> List[torch.Tensor]:
    z = _load(raw)
    return [_tensor_of(z[f"r{i}"]) for i in range(n)]


# ---------------------------------------------------------------------------
# the window service
# ---------------------------------------------------------------------------

class _LockState:
    __slots__ = ("mode", "holders", "waiters")

    def __init__(self) -> None:
        self.mode: Optional[int] = None
        self.holders: set = set()  # origin process indices
        self.waiters: deque = deque()  # (origin, type, event|None, token)


class WinService:
    """Per-runtime window service: applies incoming RMA batches into home
    windows and arbitrates passive-target locks."""

    def __init__(self, runtime) -> None:
        self.rt = runtime
        self.router = runtime.wire
        self.ep = runtime.wire.ep
        self.my_pidx = int(runtime.bootstrap["process_index"])
        self.windows: Dict[Tuple[int, int], "WireWindow"] = {}
        self._locks: Dict[Tuple[int, int, int], _LockState] = {}
        self._state_lock = threading.Lock()
        # PSCW notice sets per window key: which processes have posted
        # an exposure epoch / completed an access epoch (consumed by
        # start()/wait())
        self._posts: Dict[Tuple[int, int], set] = {}
        self._completes: Dict[Tuple[int, int], set] = {}
        self._pscw_cv = threading.Condition(self._state_lock)
        #: token-demultiplexed replies: every outstanding request
        #: registers a slot keyed by its token; ONE thread at a time
        #: pumps the shared reply channel (``_pump_lock``) and routes
        #: each reply — and its read payload — to its slot
        self._reply_slots: Dict[int, dict] = {}
        self._reply_guard = threading.Lock()
        self._pump_lock = threading.Lock()
        #: per-request token echoed in replies: a LATE reply to a
        #: timed-out request is never mistaken for its retry's
        self._token = itertools.count(1)
        self._tuning = OscTuning()
        #: the service thread's stream per card (home batches are
        #: applied on it, never on an app thread's stream)
        self._streams: Dict[int, "torch.cuda.Stream"] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="win-service")
        self._thread.start()
        _services.add(self)  # flight-recorder lock-table visibility

    # -- lifecycle ---------------------------------------------------------
    @classmethod
    def ensure(cls, runtime) -> "WinService":
        svc = getattr(runtime, "_win_service", None)
        if svc is None:
            svc = runtime._win_service = cls(runtime)
        return svc

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)

    def tuning(self) -> OscTuning:
        """Current tuning snapshot: one generation compare on the hot
        path; any cvar write re-resolves at the next call."""
        t = self._tuning
        if t.gen != mca_var.VARS.generation:
            t = self._tuning = OscTuning()
        return t

    def register(self, win: "WireWindow") -> None:
        with self._state_lock:
            self.windows[(win.comm.cid, win.win_seq)] = win

    def unregister(self, win: "WireWindow") -> None:
        key = (win.comm.cid, win.win_seq)
        with self._state_lock:
            self.windows.pop(key, None)
            # win_seq is monotone per comm, so a freed window's notices
            # and lock entries can never be consumed again
            self._posts.pop(key, None)
            self._completes.pop(key, None)
            for lk in [k for k in self._locks if k[:2] == key]:
                del self._locks[lk]

    def _window(self, cid: int, seq: int) -> "WireWindow":
        with self._state_lock:
            w = self.windows.get((cid, seq))
        if w is None:
            raise MPIError(
                ErrorCode.ERR_WIN,
                f"window service: no window (cid={cid}, seq={seq}) — "
                "window creation order diverged across processes?",
            )
        return w

    def stream_for(self, device: torch.device):
        """The service thread's own stream on ``device``."""
        s = self._streams.get(device.index)
        if s is None:
            s = self._streams[device.index] = torch.cuda.Stream(device)
        return s

    # -- service loop ------------------------------------------------------
    def _serve(self) -> None:
        from ..btl.components import stashed_recv

        while not self._stop.is_set():
            try:
                src_nid, raw = stashed_recv(
                    self.ep, None, WIRE_WIN_SERVICE,
                    time.monotonic() + 0.2)
            except MPIError:
                continue
            except Exception:
                if self._stop.is_set():
                    return
                raise
            try:
                self._handle(src_nid - 1, raw)
            except Exception as e:
                # nothing may kill the service: a malformed frame or a
                # user error (a bad payload shape) would otherwise
                # disable all cross-process RMA for this process
                _log.verbose(1, f"win service: dropping frame from "
                                f"process {src_nid - 1}: "
                                f"{type(e).__name__}: {e}")

    def _handle(self, src_pidx: int, raw: bytes) -> None:
        env = DssBuffer(raw)
        if env.unpack_string() != _WIN_MAGIC:
            _log.verbose(1, "win service: non-window frame dropped")
            return
        cid, seq, kind, arg1, arg2, token = env.unpack_int64(6)
        cid, seq, token = int(cid), int(seq), int(token)
        if kind == KIND_BATCH:
            with _t_home.timing():
                self._handle_batch(src_pidx, cid, seq, int(arg1), token)
        elif kind == KIND_LOCK:
            win = self._window(cid, seq)
            if self.acquire(win, int(arg1), src_pidx, int(arg2),
                            event=None, token=token):
                self._reply(src_pidx, cid, seq, KIND_LOCK, [], token)
            # else: deferred — release() sends the grant later
        elif kind == KIND_ABANDON:
            win = self._window(cid, seq)
            self.abandon(win, int(arg1), src_pidx)
            self._reply(src_pidx, cid, seq, KIND_ABANDON, [], token)
        elif kind == KIND_POST:
            self.pscw_record(self._posts, (cid, seq), src_pidx)
        elif kind == KIND_COMPLETE:
            self.pscw_record(self._completes, (cid, seq), src_pidx)
        else:
            _log.verbose(1, f"win service: unknown kind {kind}")

    def _handle_batch(self, src_pidx: int, cid: int, seq: int,
                      release_target: int, token: int) -> None:
        # the payload must be consumed even if applying fails, and the
        # origin must get SOME reply or it stalls for the full request
        # timeout — failures reply KIND_ERROR
        rec = _obs.enabled  # capture once: flag may flip mid-apply
        t0 = time.perf_counter() if rec else 0.0
        with _t_recv.timing():
            payload = self.router._recv_payload(WIRE_WIN_DATA, src_pidx)
        try:
            win = self._window(cid, seq)
            with _t_unpack.timing():
                todo = _unpack_batch(payload)
            with _t_apply.timing():
                reads = win._apply_home_batch(todo)
            if release_target >= 0:
                self.release(win, release_target, src_pidx)
        except Exception as e:
            _log.verbose(1, f"win service: batch from process "
                            f"{src_pidx} failed: {e}")
            self._reply(src_pidx, cid, seq, KIND_ERROR, [], token)
            return
        if rec and _obs.enabled:
            # consumer side of the origin's (origin pidx, token) flow:
            # both values rode the request envelope
            _obs.record("win_apply", "osc", t0, time.perf_counter() - t0,
                        nbytes=payload_nbytes(payload), peer=src_pidx,
                        comm_id=cid,
                        flow=_obs.flow_id("win", src_pidx, token),
                        flow_side="t")
        self._reply(src_pidx, cid, seq, KIND_BATCH, reads, token)

    def _reply(self, dst_pidx: int, cid: int, seq: int, kind: int,
               reads: List, token: int = 0) -> None:
        with _t_reply.timing():
            self._send_reply(dst_pidx, cid, seq, kind, reads, token)

    def _send_reply(self, dst_pidx: int, cid: int, seq: int, kind: int,
                    reads: List, token: int) -> None:
        env = DssBuffer()
        env.pack_string(_WIN_MAGIC)
        env.pack_int64([cid, seq, kind, len(reads), token])
        self.router._retry(
            lambda: self.ep.send(self.router._nid(dst_pidx),
                                 WIRE_WIN_REPLY, env.tobytes()),
            f"window reply to process {dst_pidx}",
        )
        if reads:
            # only the service thread sends replies that carry reads, so
            # an envelope and its payload are never split by another's
            self.router._send_payload(dst_pidx, WIRE_WIN_RDATA,
                                      _pack_reads(reads))

    # -- origin-side request/reply -----------------------------------------
    def _send_lock(self, peer_pidx: int) -> threading.Lock:
        """Per-peer outbound framing lock: an envelope and its payload
        must land back-to-back on the peer's FIFO; it is held only for
        the send, never across a reply wait."""
        return self.router._chan_lock("win_send", peer_pidx)

    def _pump_replies(self, deadline: float) -> None:
        """Pop ONE reply (and its read payload, if any) off the shared
        reply channel and route it to its token's slot. Caller holds
        ``_pump_lock``. A reply whose requester already timed out is
        drained and dropped, its payload consumed here so the next
        reply cannot unpack the wrong arrays."""
        from ..btl.components import stashed_recv

        try:
            src_nid, raw = stashed_recv(self.ep, None, WIRE_WIN_REPLY,
                                        deadline)
        except MPIError as e:
            if e.code is ErrorCode.ERR_PENDING:
                return  # nothing within the slice; caller re-checks
            raise  # endpoint closed / link dead: surface it now
        renv = DssBuffer(raw)
        if renv.unpack_string() != _WIN_MAGIC:
            raise MPIError(ErrorCode.ERR_INTERN,
                           "corrupt window reply envelope")
        rcid, rseq, rkind, n_reads, rtoken = renv.unpack_int64(5)
        reads: List[torch.Tensor] = []
        if int(n_reads) and int(rkind) != KIND_ERROR:
            rdata = self.router._recv_payload(WIRE_WIN_RDATA, src_nid - 1)
            reads = _unpack_reads(rdata, int(n_reads))
        with self._reply_guard:
            slot = self._reply_slots.get(int(rtoken))
            if slot is None:
                _log.verbose(
                    1, f"discarding stale window reply (cid={rcid}, "
                       f"seq={rseq}, kind={rkind}, token={rtoken})")
                return
            slot["cid"], slot["seq"] = int(rcid), int(rseq)
            slot["kind"] = int(rkind)
            slot["reads"] = reads
            slot["ev"].set()

    def request(self, win: "WireWindow", owner_pidx: int, kind: int,
                arg1: int, arg2: int,
                payload: Optional[np.ndarray] = None,
                timeout_ms: Optional[int] = None) -> List[torch.Tensor]:
        """Send one request to ``owner_pidx`` and await its reply; returns
        the read tensors. Any number of threads may have requests
        outstanding: while one waits for a deferred lock grant, the
        thread whose unlock produces that grant goes through its own
        request/reply unimpeded."""
        if timeout_ms is None:
            timeout_ms = self.tuning().request_timeout_ms
        token = next(self._token)
        _win_requests.add()
        rec = _obs.enabled  # capture once: flag may flip mid-request
        wd_tok = None
        if _watchdog.enabled:
            wd_tok = _watchdog.arm(
                f"win_request_kind{kind}", comm_id=win.comm.cid,
                peer=owner_pidx,
                info={"win_seq": win.win_seq, "token": token,
                      "arg1": arg1, "arg2": arg2},
            )
        slot = {"ev": threading.Event(), "reads": None, "kind": None,
                "cid": -1, "seq": -1}
        with self._reply_guard:
            self._reply_slots[token] = slot
        t0 = time.perf_counter()
        try:
            env = DssBuffer()
            env.pack_string(_WIN_MAGIC)
            env.pack_int64([win.comm.cid, win.win_seq, kind, arg1, arg2,
                            token])
            with self._send_lock(owner_pidx):
                self.router._retry(
                    lambda: self.ep.send(self.router._nid(owner_pidx),
                                         WIRE_WIN_SERVICE, env.tobytes()),
                    f"window request to process {owner_pidx}",
                )
                if payload is not None:
                    self.router._send_payload(owner_pidx, WIRE_WIN_DATA,
                                              payload)
            if rec and _obs.enabled:
                # producer side: the home's win_apply span derives the
                # same (origin pidx, token) id from the envelope
                _obs.record(
                    "win_request", "osc", t0, time.perf_counter() - t0,
                    nbytes=payload_nbytes(payload),
                    peer=owner_pidx, comm_id=win.comm.cid,
                    flow=_obs.flow_id("win", self.my_pidx, token),
                    flow_side="s")
            deadline = time.monotonic() + timeout_ms / 1000
            while not slot["ev"].is_set():
                # one thread at a time pumps the shared channel; the
                # others park on their event, woken the instant the
                # pump routes their reply
                if self._pump_lock.acquire(blocking=False):
                    try:
                        if slot["ev"].is_set():
                            break
                        self._pump_replies(time.monotonic() + 0.2)
                    finally:
                        self._pump_lock.release()
                else:
                    slot["ev"].wait(timeout=0.02)
                if slot["ev"].is_set():
                    break
                if time.monotonic() >= deadline:
                    raise MPIError(
                        ErrorCode.ERR_PENDING,
                        f"window request (kind {kind}) to process "
                        f"{owner_pidx} got no reply within "
                        f"{timeout_ms / 1000:.0f}s",
                    )
        finally:
            if wd_tok is not None:
                _watchdog.disarm(wd_tok)
            with self._reply_guard:
                self._reply_slots.pop(token, None)
            _t_request.add(time.perf_counter() - t0)
        if slot["kind"] == KIND_ERROR:
            raise MPIError(
                ErrorCode.ERR_RMA_SYNC,
                f"window request (kind {kind}) failed at its home "
                f"process {owner_pidx} — bad payload shape/dtype for the "
                "target window?",
            )
        if (slot["cid"], slot["seq"], slot["kind"]) != (
                win.comm.cid, win.win_seq, kind):
            raise MPIError(
                ErrorCode.ERR_INTERN,
                f"window reply token {token} carries (cid={slot['cid']}, "
                f"seq={slot['seq']}, kind={slot['kind']}), expected "
                f"(cid={win.comm.cid}, seq={win.win_seq}, kind={kind})",
            )
        return slot["reads"] or []

    # -- PSCW notices (one-way; no reply awaited) --------------------------
    def notify(self, dst_pidx: int, win: "WireWindow", kind: int) -> None:
        env = DssBuffer()
        env.pack_string(_WIN_MAGIC)
        env.pack_int64([win.comm.cid, win.win_seq, kind, 0, 0, 0])
        with self._send_lock(dst_pidx):
            self.router._retry(
                lambda: self.ep.send(self.router._nid(dst_pidx),
                                     WIRE_WIN_SERVICE, env.tobytes()),
                f"window notice (kind {kind}) to process {dst_pidx}",
            )

    def pscw_record(self, table: Dict, key: Tuple[int, int],
                    pidx: int) -> None:
        with self._pscw_cv:
            table.setdefault(key, set()).add(pidx)
            self._pscw_cv.notify_all()

    def pscw_check(self, table: Dict, key: Tuple[int, int],
                   procs) -> bool:
        """Non-consuming peek: have all of ``procs`` recorded their
        notice? (MPI_Win_test's question.)"""
        with self._pscw_cv:
            return set(procs) <= table.get(key, set())

    def pscw_await(self, table: Dict, key: Tuple[int, int], procs,
                   what: str) -> None:
        """Block until every process in ``procs`` has recorded its
        notice, then CONSUME those notices (the next epoch waits for its
        own). Unbounded by default, as MPI requires;
        ``osc_pscw_timeout_s`` bounds it."""
        want = set(procs)
        if not want:  # MPI_GROUP_EMPTY epochs are legal no-ops
            return
        timeout_s = self.tuning().pscw_timeout_s
        deadline = (time.monotonic() + timeout_s) if timeout_s else None
        wd_tok = None
        if _watchdog.enabled:
            wd_tok = _watchdog.arm(
                f"pscw_{what}", comm_id=key[0],
                info=lambda: {"awaiting_procs": sorted(
                    want - table.get(key, set()))},
            )
        try:
            with self._pscw_cv:
                while not want <= table.get(key, set()):
                    if (deadline is not None
                            and deadline <= time.monotonic()):
                        raise MPIError(
                            ErrorCode.ERR_RMA_SYNC,
                            f"PSCW {what} timed out awaiting processes "
                            f"{sorted(want - table.get(key, set()))}",
                        )
                    self._pscw_cv.wait(timeout=1.0)
                table[key] -= want
        finally:
            if wd_tok is not None:
                _watchdog.disarm(wd_tok)

    # -- home-side lock table ----------------------------------------------
    @staticmethod
    def _lock_key(win: "WireWindow", target: int) -> Tuple[int, int, int]:
        return (win.comm.cid, win.win_seq, target)

    def acquire(self, win: "WireWindow", target: int, origin: int,
                lock_type: int, event: Optional[threading.Event],
                token: int = 0) -> bool:
        """Try to acquire ``target``'s lock for ``origin``: True when
        granted now; otherwise the waiter is queued (a remote origin
        gets its grant reply, echoing ``token``, from :meth:`release`; a
        local one waits on ``event``)."""
        with self._state_lock:
            st = self._locks.setdefault(self._lock_key(win, target),
                                        _LockState())
            grantable = (
                not st.holders
                or (st.mode == LOCK_SHARED and lock_type == LOCK_SHARED
                    and not st.waiters)  # don't starve a queued EXCL
            )
            if grantable:
                st.mode = lock_type
                st.holders.add(origin)
                return True
            st.waiters.append((origin, lock_type, event, token))
            return False

    def release(self, win: "WireWindow", target: int, origin: int) -> None:
        grants: List[Tuple[int, int]] = []  # (remote origin, token)
        with self._state_lock:
            st = self._locks.get(self._lock_key(win, target))
            if st is None or origin not in st.holders:
                raise MPIError(
                    ErrorCode.ERR_RMA_SYNC,
                    f"unlock of target {target} not held by process "
                    f"{origin}",
                )
            st.holders.discard(origin)
            if not st.holders:
                st.mode = None
                while st.waiters:
                    o, t, ev, tok = st.waiters[0]
                    if st.mode is None:
                        st.mode = t
                    elif not (st.mode == LOCK_SHARED
                              and t == LOCK_SHARED):
                        break
                    st.waiters.popleft()
                    st.holders.add(o)
                    if ev is not None:
                        # a LOCAL grant: set inside the lock, so a
                        # timed-out acquire_blocking can tell "granted"
                        # from "still waiting"
                        ev.set()
                    else:
                        grants.append((o, tok))
                    if t == LOCK_EXCLUSIVE:
                        break
        for origin_p, tok in grants:
            self._reply(origin_p, win.comm.cid, win.win_seq, KIND_LOCK, [],
                        tok)

    def abandon(self, win: "WireWindow", target: int, origin: int) -> None:
        """Forget ``origin``'s interest in ``target``'s lock: drop its
        waiter entry, or release a grant it never saw."""
        with self._state_lock:
            st = self._locks.get(self._lock_key(win, target))
            if st is None:
                return
            st.waiters = deque(w for w in st.waiters if w[0] != origin)
            ghost = origin in st.holders
        if ghost:
            self.release(win, target, origin)

    def acquire_blocking(self, win: "WireWindow", target: int,
                         lock_type: int,
                         timeout_s: Optional[float] = None) -> None:
        """A local origin's acquire against the home table (remote
        origins contend through the same table), bounded by the same
        request timeout."""
        if timeout_s is None:
            timeout_s = self.tuning().request_timeout_ms / 1000.0
        ev = threading.Event()
        if self.acquire(win, target, self.my_pidx, lock_type, event=ev):
            return
        wd_tok = None
        if _watchdog.enabled:
            wd_tok = _watchdog.arm(
                "win_lock_wait", comm_id=win.comm.cid, peer=target,
                info={"win_seq": win.win_seq, "lock_type": lock_type},
            )
        try:
            granted = ev.wait(timeout=timeout_s)
        finally:
            if wd_tok is not None:
                _watchdog.disarm(wd_tok)
        if granted:
            return
        with self._state_lock:
            if ev.is_set():
                return  # granted in the race window — we hold it
            st = self._locks.get(self._lock_key(win, target))
            if st is not None:
                st.waiters = deque(w for w in st.waiters
                                   if w[2] is not ev)
        raise MPIError(
            ErrorCode.ERR_RMA_SYNC,
            f"timed out waiting for lock on target {target} (held "
            f"elsewhere for > {timeout_s:.0f}s)",
        )


# ---------------------------------------------------------------------------
# the spanning window
# ---------------------------------------------------------------------------

class WireWindow(Window):
    """A window on a communicator spanning controller processes: this
    process stores one slice per LOCAL member; RMA to remote targets
    ships to the target's home at synchronization. Creation is
    collective and synchronizing (like MPI_Win_create), so a peer's
    first batch never outruns the window's existence."""

    def __init__(self, comm, base, name: str = "", *,
                 _owned: bool = False) -> None:
        rt = comm.runtime
        if getattr(rt, "wire", None) is None:
            raise MPIError(
                ErrorCode.ERR_WIN,
                "spanning-comm window needs the wire router "
                "(runtime_unified_world)",
            )
        t = proc_topology(comm)  # the one shared layout derivation
        self.router = t.router
        self.my_pidx = t.my_pidx
        self.owner = t.owner
        self.local_ranks = t.local_ranks
        self.local_n = t.local_n
        if base.shape[0] != self.local_n:
            raise MPIError(
                ErrorCode.ERR_WIN,
                f"spanning-comm window base carries one slice per LOCAL "
                f"member ({self.local_n}), got leading axis "
                f"{base.shape[0]}",
            )
        self._init_state(comm, base, name, _owned)
        # collective creation: the same per-comm sequence everywhere
        self.win_seq = getattr(comm, "_win_seq", 0)
        comm._win_seq = self.win_seq + 1
        self.service = WinService.ensure(rt)
        self.service.register(self)
        comm.barrier()  # MPI_Win_create is collective + synchronizing

    # -- storage indexing --------------------------------------------------
    def _local_pos(self, target: int) -> int:
        return self.local_ranks.index(target)

    def _read_row(self, rank: int) -> torch.Tensor:
        """A snapshot of a LOCAL member's slice."""
        return self._data[self._local_pos(rank)].clone()

    def _remote(self, target: int) -> bool:
        """``target`` is a rank of the comm another process owns (an
        out-of-range target is left to ``Window._queue``'s check)."""
        return 0 <= target < len(self.owner) \
            and self.owner[target] != self.my_pidx

    def _payload(self, x, target: int) -> torch.Tensor:
        """The call-time copy of a payload: on the window's device for a
        local target, on the host for a target in another process (it is
        serialized at the epoch close)."""
        if self._remote(target):
            return copy_to(x, "cpu")
        return copy_to(x, self._data.device)

    def _queue(self, op: _PendingOp):
        """Refuse at the call site what the wire cannot ship: a
        user-defined op bound for a remote home (by op-object IDENTITY —
        a user op sharing a predefined name would otherwise ship its
        name and the home would apply the predefined combiner)."""
        if (op.op is not None
                and PREDEFINED_OPS.get(op.op.name) is not op.op
                and self._remote(op.target)):
            raise MPIError(
                ErrorCode.ERR_OP,
                f"cross-process RMA requires a predefined op, got "
                f"'{op.op.name}' (MPI_Accumulate's own rule)",
            )
        return super()._queue(op)

    # -- epoch close: split local / per-home batches -----------------------
    def _apply_pending(self, only_target: Optional[int] = None) -> None:
        from . import plan as _osc_plan
        from .window import _epoch_count

        with self._op_lock:
            if not self._pending:
                return
            _epoch_count.add()
            todo = self._take_pending(only_target)
            if not todo:
                return
            local: List[_PendingOp] = []
            remote: Dict[int, List[_PendingOp]] = {}
            for p in todo:
                own = self.owner[p.target]
                if own == self.my_pidx:
                    local.append(p)
                else:
                    remote.setdefault(own, []).append(p)
            if local:
                remapped = [
                    _PendingOp(p.kind, self._local_pos(p.target),
                               data=p.data, op=p.op, request=p.request,
                               compare=p.compare, index=p.index,
                               status_rank=p.target)
                    for p in local
                ]
                t0 = time.perf_counter()
                if not _osc_plan.close_epoch(self, remapped, t0):
                    self._run_epoch_program(remapped, _t0=t0)
        # ship OUTSIDE _op_lock: holding it while awaiting the peer's ack
        # would deadlock two processes fencing into each other (each
        # service thread needs the lock to apply the other's batch)
        for own in sorted(remote):
            self._ship_batch(own, remote[own], release_target=-1)

    def _ship_batch(self, owner_pidx: int, ops: List[_PendingOp],
                    release_target: int) -> None:
        from . import plan as _osc_plan

        # a seen batch signature renders through its frozen template;
        # the bytes are _pack_batch's either way
        with _t_pack.timing():
            payload = _osc_plan.batch_payload(self, ops)
        reads = self.service.request(
            self, owner_pidx, KIND_BATCH, release_target, 0,
            payload=payload,
        )
        want = [p for p in ops if p.request is not None]
        if len(want) != len(reads):
            raise MPIError(
                ErrorCode.ERR_INTERN,
                f"window batch reply carried {len(reads)} reads for "
                f"{len(want)} read-requests",
            )
        for p, v in zip(want, reads):
            p.request.complete(value=v, status=Status(source=p.target))

    def _apply_home_batch(self, todo: List[_PendingOp]) -> List:
        """Service side: apply a peer's batch into the local slices and
        return the read values in op order, on the host. On the card the
        batch moves to the window's device and is applied on the
        service's own stream, every launch and copy under the capture
        lock; the stream is drained before the reply, so an ack means the
        bytes landed."""
        from . import plan as _osc_plan

        for p in todo:
            if self.owner[p.target] != self.my_pidx:
                raise MPIError(
                    ErrorCode.ERR_RANK,
                    f"batch targets rank {p.target}, owned by process "
                    f"{self.owner[p.target]}, not {self.my_pidx}",
                )
            p.status_rank = p.target
            p.target = self._local_pos(p.target)
        dev = self._data.device
        t_wait = time.perf_counter()
        with self._op_lock:
            if dev.type != "cuda":
                _t_wait.add(time.perf_counter() - t_wait)
                t0 = time.perf_counter()
                if not _osc_plan.close_epoch(self, todo, t0):
                    self._run_epoch_program(todo, _t0=t0)
                _t_close.add(time.perf_counter() - t0)
            else:
                stream = self.service.stream_for(dev)
                with capture_lock, torch.cuda.device(dev), \
                        torch.cuda.stream(stream):
                    _t_wait.add(time.perf_counter() - t_wait)
                    # app threads write the window on the device's
                    # default stream: order this batch after them
                    stream.wait_stream(torch.cuda.default_stream(dev))
                    for p in todo:
                        if p.data is not None:
                            p.data = p.data.to(dev, non_blocking=False)
                        if p.compare is not None:
                            p.compare = p.compare.to(dev,
                                                     non_blocking=False)
                    t0 = time.perf_counter()
                    if not _osc_plan.close_epoch(self, todo, t0):
                        self._run_epoch_program(todo, _t0=t0)
                    t1 = time.perf_counter()
                    _t_close.add(t1 - t0)
                    stream.synchronize()
                    reads = [p.request.value.cpu() for p in todo
                             if p.request is not None]
                    _t_drain.add(time.perf_counter() - t1)
                    return reads
        return [p.request.value for p in todo if p.request is not None]

    # -- passive target over the home lock table ---------------------------
    def lock(self, target: int, lock_type: int = LOCK_EXCLUSIVE) -> None:
        self._require(_EpochKind.NONE, _EpochKind.LOCK)
        if target in self._locked:
            raise MPIError(ErrorCode.ERR_RMA_SYNC,
                           f"target {target} already locked")
        self._acquire(target, lock_type)
        self._locked[target] = lock_type
        self._epoch = _EpochKind.LOCK

    def _acquire(self, target: int, lock_type: int) -> None:
        own = self.owner[target]
        if own == self.my_pidx:
            self.service.acquire_blocking(self, target, lock_type)
            return
        try:
            self.service.request(self, own, KIND_LOCK, target, lock_type)
        except MPIError:
            # timed out awaiting the grant: tell the home to forget us,
            # so the lock cannot wedge on a ghost holder
            try:
                self.service.request(
                    self, own, KIND_ABANDON, target, 0,
                    timeout_ms=self.service.tuning().abandon_timeout_ms)
            except MPIError:
                pass  # home unreachable; nothing more to clean
            raise

    def lock_all(self) -> None:
        """Shared lock on every target (remote ones at their homes)."""
        self._require(_EpochKind.NONE)
        for t in range(self.comm.size):
            self._acquire(t, LOCK_SHARED)
            self._locked[t] = LOCK_SHARED
        self._epoch = _EpochKind.LOCK

    def _release_one(self, target: int) -> None:
        own = self.owner[target]
        if own == self.my_pidx:
            self._apply_pending(only_target=target)
            self.service.release(self, target, self.my_pidx)
        else:
            with self._op_lock:
                ops = self._take_pending(only_target=target)
            self._ship_batch(own, ops, release_target=target)

    def unlock(self, target: int) -> None:
        self._require(_EpochKind.LOCK)
        if target not in self._locked:
            raise MPIError(ErrorCode.ERR_RMA_SYNC,
                           f"target {target} not locked")
        self._release_one(target)
        del self._locked[target]
        if not self._locked:
            self._epoch = _EpochKind.NONE

    def unlock_all(self) -> None:
        self._require(_EpochKind.LOCK)
        for t in sorted(self._locked):
            self._release_one(t)
        self._locked.clear()
        self._epoch = _EpochKind.NONE

    # -- PSCW (generalized active target) across processes -----------------
    # post -> a one-way notice to every accessor process; start blocks
    # for its targets' notices; complete ships and acks the batches THEN
    # notifies each target (one sender's service frames are processed in
    # order, so a COMPLETE never passes its own epoch's data); wait
    # blocks for every accessor process's COMPLETE: osc/rdma's PSCW
    # state machine at process granularity.

    def _procs_of_group(self, group) -> List[int]:
        return sorted({self.router.owner_of(r) for r in group.world_ranks})

    def _key(self) -> Tuple[int, int]:
        return (self.comm.cid, self.win_seq)

    def post(self, group) -> None:
        # post-then-start and start-then-post are both legal on a process
        # that is target and origin, so an open access epoch does not
        # forbid opening the exposure side
        self._require(_EpochKind.NONE, _EpochKind.PSCW)
        if self._group_exposed is not None:
            raise MPIError(ErrorCode.ERR_RMA_SYNC,
                           "post() with an exposure epoch already open")
        self._group_exposed = group
        self._epoch = _EpochKind.PSCW
        for p in self._procs_of_group(group):
            if p == self.my_pidx:
                self.service.pscw_record(self.service._posts, self._key(),
                                         self.my_pidx)
            else:
                self.service.notify(p, self, KIND_POST)

    def start(self, group) -> None:
        self._require(_EpochKind.NONE, _EpochKind.PSCW)
        targets = self._procs_of_group(group)
        self.service.pscw_await(self.service._posts, self._key(),
                                targets, "start")
        self._start_procs = targets
        self._epoch = _EpochKind.PSCW

    def complete(self) -> None:
        self._require(_EpochKind.PSCW)
        self._apply_pending()  # ships + acks every remote batch first
        for p in getattr(self, "_start_procs", []):
            if p == self.my_pidx:
                self.service.pscw_record(self.service._completes,
                                         self._key(), self.my_pidx)
            else:
                self.service.notify(p, self, KIND_COMPLETE)
        self._start_procs = []
        # the epoch stays open while the exposure side is: a fence()
        # between complete() and wait() must still raise
        self._epoch = (_EpochKind.NONE if self._group_exposed is None
                       else _EpochKind.PSCW)

    def wait(self) -> None:
        if self._group_exposed is None:
            raise MPIError(ErrorCode.ERR_RMA_SYNC,
                           "wait() without a matching post()")
        accessors = self._procs_of_group(self._group_exposed)
        self.service.pscw_await(self.service._completes, self._key(),
                                accessors, "wait")
        if self._epoch is _EpochKind.PSCW:
            self._apply_pending()
            self._epoch = _EpochKind.NONE
        self._group_exposed = None

    def test(self) -> bool:
        """MPI_Win_test: True (and the exposure closes, like wait)
        exactly when every accessor process's COMPLETE has arrived."""
        if self._group_exposed is None:
            raise MPIError(ErrorCode.ERR_RMA_SYNC,
                           "test() without a matching post()")
        accessors = self._procs_of_group(self._group_exposed)
        if not self.service.pscw_check(self.service._completes,
                                       self._key(), accessors):
            return False
        self.wait()  # consumes the notices; does not block
        return True

    def free(self) -> None:
        super().free()
        # the mirror image of the creation barrier: peers may still have
        # release batches in flight to this home
        self.comm.barrier()
        self.service.unregister(self)

    def shared_query(self, rank: int):
        raise MPIError(
            ErrorCode.ERR_RMA_SHARED,
            "shared windows cannot span controller processes (device "
            "buffers are per-process); use a split_type_shared "
            "communicator",
        )
