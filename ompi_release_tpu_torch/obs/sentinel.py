"""Collective contract sentinel — cross-rank call-signature hashing.

The obs plane answers "where is time going" (journal + skew pvars)
and "who is stuck" (watchdog + doctor); this module
makes a third defect class visible: cross-rank collective *desyncs* —
one rank posts ``bcast`` where the others posted ``allreduce``,
mismatched op/dtype/count/root, a posting-order swap, a stale-epoch
survivor calling into a rebuilt world — which otherwise surface only
as a watchdog stall or silently wrong numbers. The discipline is the
MUST-style collective-consistency check built on the reference's own
introspection pattern (PERUSE call-stream events + MPI_T, PAPER.md §1):
the library observes its own call stream.

Every collective entry (blocking, i-family, persistent ``start()``,
serialized collective IO) computes a compact **call signature**::

    (cid, per-comm posting seq, family, reduction op, dtype,
     per-rank count, root)  +  job epoch  +  call-site fingerprint

The signature folds into a per-communicator **rolling hash chain**
(FNV-1a, process-independent — the same fold :func:`obs.journal
.flow_id` uses), so two ranks that executed the same call stream hold
the same chain value, and the FIRST divergence pins the desync to one
``(cid, seq)``. The call site (user-frame ``file:line``) is forensics
only — it is *excluded* from the compared hash, because different
ranks may legitimately reach one collective from different code paths.

Two consumption modes, selected by the ``obs_sentinel`` cvar:

``obs_sentinel=1`` (post-hoc)
    Signatures are recorded as journal events (layer ``"sentinel"``)
    and kept in a per-comm last-N ring that rides every watchdog
    postmortem. ``tpu-doctor contracts DIR`` aligns the per-comm
    posting sequences across merged rank journals (finalize dumps OR
    postmortems of a hung run) and names the first divergence:
    missing participant, op/dtype/count mismatch, posting-order swap,
    epoch skew — with both call sites.

``obs_sentinel=2`` (inline)
    Additionally, the 16-byte signature digest (sig hash + site hash)
    piggybacks on the first wire/ctl frame of each spanning round
    (:meth:`~..runtime.wire.WireRouter.sentinel_exchange`): every
    member process exchanges its signature BEFORE the round's payload
    traffic, and a divergence raises the typed ``ERR_COLL_MISMATCH``
    within that round — naming the first divergent process, the
    expected-vs-actual signature fields, and both call sites —
    instead of hanging into a watchdog timeout. A late peer's wait in
    the exchange is the round's: the watchdog arm names the
    collective and the processes not yet heard from, and the round's
    coll span opens at arrival, before the exchange
    (:func:`take_arrival`), so the skew report names the late process.

Cost discipline is the plane's one-attribute-check contract, enforced
by
``tests/test_obs_gating.py``'s AST scan: every emit site here and at
the entry points (``coll/nbc.py``, ``comm/communicator.py``) is gated
on one module attribute (``sentinel.enabled`` / ``_obs.enabled``), so
``obs_sentinel=0`` costs a single attribute check per collective.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time as _time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .. import obs as _obs
from ..mca import pvar as _pvar
from ..mca import var as _var
from ..utils.errors import ErrorCode, MPIError
from .journal import flow_id

#: THE gate: entry points check this and do nothing else when False.
#: Recomputed by refresh() on obs enable/disable and cvar changes.
enabled: bool = False

_mode: int = 0
_lock = threading.Lock()

#: families whose second positional argument is a reduction Op
_REDUCING = frozenset((
    "allreduce", "reduce", "reduce_scatter_block", "scan", "exscan",
))
#: family -> index (within the comm-stripped args) of the root operand
_ROOT_ARG = {"bcast": 1, "gather": 1, "scatter": 1, "reduce": 2,
             "gatherv": 1, "scatterv": 2}

#: wire frame prefix of an inline signature exchange (ctl channel)
SIG_MAGIC = b"SIG1"

DEFAULT_RING = 16

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ops_hashed = _pvar.counter(
    "sentinel_ops_hashed",
    "collective call signatures folded into per-comm hash chains by "
    "the contract sentinel (obs_sentinel >= 1)",
)
_mismatches = _pvar.counter(
    "sentinel_mismatches",
    "cross-rank collective contract violations detected (inline "
    "signature exchanges that raised ERR_COLL_MISMATCH)",
)


def register_vars() -> None:
    _var.register(
        "obs_sentinel", "int", 0,
        "Collective contract sentinel mode: 0 = off (one attribute "
        "check per collective), 1 = post-hoc — record call signatures "
        "as journal events for tpu-doctor contracts, 2 = inline — "
        "additionally exchange the signature on the comm's ctl "
        "channel before each spanning round and raise "
        "ERR_COLL_MISMATCH on divergence (needs the obs plane "
        "enabled)",
    )
    _var.register(
        "obs_sentinel_ring", "int", DEFAULT_RING,
        "Last-N call signatures kept per communicator for watchdog "
        "postmortems (the tpu-doctor contracts input when the "
        "journal ring has wrapped past them)",
    )


register_vars()  # idempotent; cvars must exist before any refresh()


class _Chain:
    """Per-communicator sentinel state: the next posting seq, the
    rolling hash chain, and the last-N signature ring."""

    __slots__ = ("seq", "chain", "ring")

    def __init__(self, ring: int) -> None:
        self.seq = 0
        self.chain = 0
        self.ring: deque = deque(maxlen=max(1, int(ring)))


_chains: Dict[int, _Chain] = {}


def refresh(obs_enabled: Optional[bool] = None) -> None:
    """Recompute the gate from the obs flag + the obs_sentinel cvar."""
    global enabled, _mode
    if obs_enabled is None:
        from . import is_enabled

        obs_enabled = is_enabled()
    _mode = int(_var.get("obs_sentinel", 0) or 0)
    enabled = bool(obs_enabled and _mode > 0)


def mode() -> int:
    """The active sentinel mode (0 when the gate is off)."""
    return _mode if enabled else 0


# ---------------------------------------------------------------------------
# signature derivation
# ---------------------------------------------------------------------------


def _call_site() -> str:
    """User-frame ``file:line`` fingerprint: the first stack frame
    outside this package (basename only — compact, and the postmortem
    already carries full paths in its thread stacks)."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.startswith(_PKG_DIR) and not fn.startswith("<"):
            return f"{os.path.basename(fn)}:{f.f_lineno}"
        f = f.f_back
    return "<internal>"


def dtype_name(dt) -> str:
    """The canonical dtype text of a signature: numpy's names
    (``float32``, ``bfloat16``, ``int32``), which torch dtypes print
    with a ``torch.`` prefix — stripped, so a call stream hashes to the
    same chain whichever array type carried it."""
    s = str(dt)
    return s[6:] if s.startswith("torch.") else s


def _describe(comm, family: str, args: Tuple, kw: Dict
              ) -> Tuple[str, str, int, int]:
    """Best-effort (op, dtype, per-rank count, root) from a collective
    entry's arguments. The leading local-rank axis of driver-mode
    buffers is STRIPPED from the count: each controller process passes
    arrays for its own rank span, so the cross-rank invariant is the
    per-rank payload, not the stacked buffer. Ragged v-variant buffer
    lists hash as count -1 (their per-rank counts differ by design)."""
    if args and args[0] is comm:
        args = args[1:]
    x = args[0] if args else None
    op_name = "-"
    if family in _REDUCING:
        op = kw.get("op") if kw else None
        if op is None and len(args) > 1:
            op = args[1]
        op_name = str(getattr(op, "name", op if op is not None else "-"))
    elif family == "reduce_scatter":
        op = (kw.get("op") if kw else None) or \
            (args[2] if len(args) > 2 else None)
        op_name = str(getattr(op, "name", op if op is not None else "-"))
    root = -1
    ri = _ROOT_ARG.get(family)
    if ri is not None:
        if kw and "root" in kw:
            root = int(kw["root"])
        elif len(args) > ri:
            try:
                root = int(args[ri])
            except (TypeError, ValueError):
                root = -1
    dtype, count = "-", 0
    if x is not None:
        dt = getattr(x, "dtype", None)
        if dt is not None:
            dtype = dtype_name(dt)
            shape = tuple(getattr(x, "shape", ()))
            per_rank = shape[1:] if len(shape) >= 1 else shape
            count = 1
            for s in per_rank:
                count *= int(s)
        elif isinstance(x, (list, tuple)):
            count = -1  # ragged per-rank buffers (v-variants)
            if x:
                dt0 = getattr(x[0], "dtype", None)
                if dt0 is not None:
                    dtype = dtype_name(dt0)
    return op_name, dtype, count, root


class CallSig:
    """One collective entry's signature. ``sig_hash`` covers the
    cross-rank-invariant fields (cid, seq, canon); ``site_hash``
    covers the call site — together the 16-byte wire digest. The
    chain value is the per-comm rolling fold AFTER this call."""

    __slots__ = ("cid", "seq", "family", "canon", "epoch", "site",
                 "sig_hash", "site_hash", "chain")

    def __init__(self, cid: int, seq: int, family: str, canon: str,
                 epoch: int, site: str, chain_prev: int) -> None:
        self.cid = cid
        self.seq = seq
        self.family = family
        self.canon = canon
        self.epoch = epoch
        self.site = site
        # the cid stays OUT of the hash: it is already the chain's
        # key, and excluding it makes two identical call streams on
        # different comms (the selftest's determinism witness) fold
        # to the same chain value
        self.sig_hash = flow_id("sig", seq, canon)
        self.site_hash = flow_id(site)
        self.chain = flow_id(chain_prev, self.sig_hash)

    def digest(self) -> bytes:
        """The 16-byte signature: sig hash + site hash, big-endian."""
        return (self.sig_hash.to_bytes(8, "big")
                + self.site_hash.to_bytes(8, "big"))

    def descriptor(self) -> Dict[str, Any]:
        """JSON-able form: the inline wire payload, the postmortem
        ring entry, and the doctor's alignment record share it."""
        return {"seq": self.seq, "canon": self.canon,
                "epoch": self.epoch, "site": self.site,
                "sig": self.sig_hash}


def encode_op(canon: str, epoch: int, site: str) -> str:
    """The journal-event op-string form of one signature (the Span
    schema has no free-form dict, so the signature fields ride the op
    string; cid/seq ride the span's comm/peer slots)."""
    return f"{canon}|e{epoch}|{site}"


def parse_op(op: str) -> Optional[Dict[str, Any]]:
    """Invert :func:`encode_op`; None when ``op`` is not a sentinel
    signature event (THE parser — doctor and tests share it)."""
    parts = op.split("|")
    if len(parts) != 7 or not parts[5].startswith("e"):
        return None
    try:
        epoch = int(parts[5][1:])
    except ValueError:
        return None
    return {"canon": "|".join(parts[:5]), "family": parts[0],
            "epoch": epoch, "site": parts[6]}


def make_canon(family: str, op_name: str, dtype: str, count: int,
               root: int) -> str:
    """Canonical cross-rank-invariant signature text (compared
    verbatim by the doctor; hashed into ``sig_hash`` inline)."""
    return f"{family}|{op_name}|{dtype}|{count}|{root}"


# ---------------------------------------------------------------------------
# recording (the entry points' API)
# ---------------------------------------------------------------------------


def record_sig(cid: int, family: str, op_name: str = "-",
               dtype: str = "-", count: int = 0, root: int = -1,
               epoch: int = 0, site: Optional[str] = None
               ) -> Optional[CallSig]:
    """Fold one signature into ``cid``'s chain (the low-level core of
    :func:`note`, driven directly by the selftest). Returns None when
    the gate is off."""
    if not enabled:
        return None
    if site is None:
        site = _call_site()
    canon = make_canon(family, op_name, dtype, count, root)
    with _lock:
        ch = _chains.get(cid)
        if ch is None:
            ch = _chains[cid] = _Chain(
                int(_var.get("obs_sentinel_ring", DEFAULT_RING)
                    or DEFAULT_RING))
        sig = CallSig(cid, ch.seq, family, canon, epoch, site, ch.chain)
        ch.seq = sig.seq + 1
        ch.chain = sig.chain
        ch.ring.append(sig.descriptor())
    _ops_hashed.add()
    if _obs.enabled:
        _obs.record(encode_op(canon, epoch, site), "sentinel",
                    _time.perf_counter(), 0.0, nbytes=max(count, 0),
                    peer=sig.seq, comm_id=cid, flow=sig.chain,
                    flow_side="g")
    return sig


def note(comm, family: str, args: Tuple = (),
         kw: Optional[Dict] = None) -> Optional[CallSig]:
    """Record one collective entry on ``comm``. Callers gate on
    ``sentinel.enabled`` themselves (the one-attr-check contract).
    Skipped (returns None) for:

    - runtime-internal comms (negative cid — e.g. the hier module's
      process-local shadow, whose cids are NOT SPMD-agreed);
    - a collective nested inside a running schedule on the SAME comm
      (two-phase IO's closing barrier): it is part of the outer op's
      schedule, and chaining it would desync the posting seq between
      a proc whose progress thread ran the outer op early and one
      that ran it at wait().
    """
    if not enabled:
        return None
    cid = int(comm.cid)
    if cid < 0:
        return None
    if comm.spans_processes:
        from ..runtime import progress as _progress

        cur = _progress.engine().executing()
        if cur is not None and cur.key == ("comm", cid):
            return None
    try:
        from ..ft import ulfm as _ulfm

        epoch = int(_ulfm.state().epoch)
    except Exception:
        epoch = 0
    op_name, dtype, count, root = _describe(comm, family,
                                            tuple(args), kw or {})
    return record_sig(cid, family, op_name, dtype, count, root,
                      epoch=epoch, site=_call_site())


# ---------------------------------------------------------------------------
# inline verification (obs_sentinel=2, spanning comms)
# ---------------------------------------------------------------------------


class InlineFrameTemplate:
    """FrameTemplate-style precomposed inline-check payload (the ctl
    frame :func:`inline_check` exchanges): the constant descriptor
    fragments — canonical signature text and call site — are
    JSON-encoded ONCE (at plan time, cached on the frozen plan
    state), and :meth:`render` splices only the per-fire fields
    (digest, posting seq, epoch, sig hash). The bytes are IDENTICAL
    to the interpreted ``digest + json.dumps(descriptor())`` payload,
    so receivers need no changes and templated/untemplated ranks
    interoperate — this is what lets sentinel level 2 ride the
    compiled planned path instead of forcing interpretation."""

    __slots__ = ("key", "_pre_seq", "_pre_epoch", "_pre_sig")

    def __init__(self, canon: str, site: str) -> None:
        self.key = (canon, site)
        self._pre_seq = b'{"seq": '
        self._pre_epoch = (', "canon": %s, "epoch": '
                           % json.dumps(canon)).encode()
        self._pre_sig = (', "site": %s, "sig": '
                         % json.dumps(site)).encode()

    def render(self, sig: CallSig) -> bytes:
        # json.dumps of an int IS str(int), and descriptor() insertion
        # order is (seq, canon, epoch, site, sig) — splicing here is
        # byte-for-byte the interpreted payload
        return (sig.digest() + self._pre_seq + str(sig.seq).encode()
                + self._pre_epoch + str(sig.epoch).encode()
                + self._pre_sig + str(sig.sig_hash).encode() + b"}")


def wrap_inline(comm, sig: Optional[CallSig], fn,
                template: Optional[InlineFrameTemplate] = None):
    """Wrap a spanning round's schedule fn so the signature exchange
    runs at EXECUTION start — strictly before the round's first
    payload frame, in the comm's posting order on every process. A
    no-op (returns ``fn``) outside inline mode. ``template``: a
    plan-cached :class:`InlineFrameTemplate` so the steady state
    skips per-fire JSON encoding."""
    if sig is None or _mode < 2 or not comm.spans_processes:
        return fn

    def checked(*a, **k):
        t_arrive = _time.perf_counter()
        inline_check(comm, sig, template)
        _arrival.v = (sig.cid, t_arrive)
        try:
            return fn(*a, **k)
        finally:
            _arrival.v = None

    return checked


#: (cid, perf_counter at the round's arrival) of the inline-checked
#: round running on this thread, until the round's first coll span
#: takes it
_arrival = threading.local()


def take_arrival(cid: int) -> Optional[float]:
    """The arrival time of this thread's inline-checked round on
    ``cid`` — the clock read before its signature exchange — once;
    None outside such a round. The spanning round's coll span starts
    there, so the wait for a late peer in the exchange stays inside
    the span the skew report rounds on."""
    v = getattr(_arrival, "v", None)
    if v is None or v[0] != cid:
        return None
    _arrival.v = None
    return v[1]


def _rank_of(comm, pidx: int) -> int:
    """First comm rank owned by process ``pidx`` (error naming)."""
    try:
        from ..runtime.wire import proc_topology

        members = proc_topology(comm).members_of.get(pidx) or ()
        return int(members[0]) if members else -1
    except Exception:
        return -1


def inline_check(comm, sig: CallSig,
                 template: Optional[InlineFrameTemplate] = None
                 ) -> None:
    """Exchange ``sig`` with every member process of ``comm`` and
    raise ``ERR_COLL_MISMATCH`` naming the first divergent process
    when any peer's signature differs. Site hashes are excluded from
    the comparison (ranks may legitimately reach one collective from
    different code paths); posting seq and the canonical fields are
    not."""
    router = getattr(comm.runtime, "wire", None)
    if router is None:
        return
    payload = (template.render(sig) if template is not None
               else sig.digest() + json.dumps(sig.descriptor()).encode())
    frames = router.sentinel_exchange(comm, payload, op=sig.family)
    for p in sorted(frames):
        raw = frames[p]
        try:
            theirs = json.loads(raw[16:])
        except ValueError:
            theirs = {}
        if (raw[:8] == sig.digest()[:8]
                and int(theirs.get("seq", -1)) == sig.seq):
            continue
        _mismatches.add()
        if _obs.enabled:
            _obs.record("sentinel_mismatch", "sentinel",
                        _time.perf_counter(), 0.0, peer=p,
                        comm_id=sig.cid)
        mine = sig.descriptor()
        raise MPIError(
            ErrorCode.ERR_COLL_MISMATCH,
            f"collective contract violation on {comm.name} (cid "
            f"{sig.cid}): process {p} (comm rank "
            f"{_rank_of(comm, p)}) posted "
            f"{theirs.get('canon', '<unparseable>')} at seq "
            f"{theirs.get('seq', '?')} from "
            f"{theirs.get('site', '?')} where this process posted "
            f"{mine['canon']} at seq {mine['seq']} from "
            f"{mine['site']} (epochs: theirs "
            f"{theirs.get('epoch', '?')}, ours {mine['epoch']})",
        )


# ---------------------------------------------------------------------------
# introspection (postmortems, finalize dumps, selftest)
# ---------------------------------------------------------------------------


def clear_chain(cid: int) -> None:
    """Drop ``cid``'s chain state. Called when a communicator is
    freed (the contract story is closed — journal events persist for
    post-hoc alignment, and chains must not accumulate over comm
    churn) and on the explicit-cid rebuild path's slot eviction: a
    survivor's leftover chain resuming at seq > 0 against a
    restarted-from-zero replacement's fresh seq 0 would be a FALSE
    mismatch on a healthy rebuilt world. Cheap when the sentinel
    never ran (one falsy dict check, no lock)."""
    if not _chains:
        return
    with _lock:
        _chains.pop(cid, None)


def clear_band(lo: int, hi: int) -> None:
    """Drop every chain with ``lo <= cid < hi`` — the tenant-eviction
    / tenant-slot-reuse sweep (service plane): a dead tenant's
    leftover posting seqs must not false-mismatch the NEXT tenant
    admitted into the same cid band. Cheap when the sentinel never
    ran (one falsy dict check, no lock)."""
    if not _chains:
        return
    with _lock:
        for cid in [c for c in _chains if lo <= c < hi]:
            _chains.pop(cid, None)


def chain_of(cid: int) -> int:
    """Current rolling chain value for ``cid`` (0 = no calls seen)."""
    with _lock:
        ch = _chains.get(cid)
        return ch.chain if ch is not None else 0


def chains_snapshot() -> Dict[str, Any]:
    """Per-comm sentinel state for the watchdog postmortem and the
    finalize dump's meta: mode, and per cid the next posting seq, the
    chain value, and the last-N signature descriptors (the doctor's
    alignment input when the journal ring wrapped past them)."""
    with _lock:
        comms = {
            str(cid): {"next_seq": ch.seq,
                       "chain": f"{ch.chain:016x}",
                       "last": list(ch.ring)}
            for cid, ch in _chains.items()
        }
    return {"mode": _mode, "comms": comms}


def _reset_for_tests() -> None:
    global enabled, _mode
    with _lock:
        _chains.clear()
    enabled = False
    _mode = 0


# every watchdog postmortem carries the per-comm signature rings, so a
# hung mismatched run's dumps feed `tpu-doctor contracts` even when
# the journal tail wrapped past the divergent round
from . import watchdog as _watchdog  # noqa: E402

_watchdog.add_contributor("sentinel", chains_snapshot)
