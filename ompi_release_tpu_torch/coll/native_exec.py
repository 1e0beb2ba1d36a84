"""Native plan execution — run frozen wire rounds end-to-end in C (the
port's counterpart of ``ompi_release_tpu/coll/native_exec.py``).

A frozen :class:`~.plan.WirePlan` replayed through
:class:`~.plan.PlannedXchg` still meets Python once per round:
per-fragment generator ``next()`` calls, per-arrival reap callbacks,
fresh reassembly buffers. This module lowers a whole plan into a flat C
descriptor table (``native/planexec.cc``) so a fire becomes ONE ctypes
call per ~100 ms slice: sends stripe through the existing shm-ring
writev / vectored-socket legs with the interpreted path's exact
FIFO-per-peer and depth discipline, receives land in a per-plan
preallocated reassembly pool reused across fires.

How rounds >= 1 get their bytes without Python: at descriptor-compile
time (of a plan of more than one round; a one-round plan sends its
round-0 arrays verbatim and needs no probe) the schedule body runs
TWICE against a wire-free probe adapter,
each time over fresh random-byte inputs and random-byte synthetic
receives. Every later-round send payload is then located inside the
concatenation of (input regions | receive-pool regions) by unique
16-byte windows — a scatter-gather map of ``(region, offset, length)``
spans. Random bytes make any coincidental match astronomically
unlikely, and the two independently-seeded probes must infer the SAME
map or the plan stays on ``PlannedXchg``. The map is exact byte
provenance: at fire time C composes each send from live region bytes,
so the wire traffic is bitwise-identical to the interpreted path's. A
round that resends a partial FOLDED from received bytes (ring and
Rabenseifner's second half) has no byte provenance, so such plans stay
on ``PlannedXchg`` — by design, as in the reference.

The port's schedule body is the hier collective on tensors: the probe
inputs are random-byte tensors of the call's own dtype on the
communicator's device (so the shadow comm's collective runs the very
signature a real call has, never one of its own), and the random
receives are host arrays in the schedules' storage dtype (bf16 as
``uint16`` words). Random f32/bf16 bits include NaN and Inf; only the
structure and the raw payload bytes of a probe are read, never its
values. An argument region is handed to C only when a map reads it: a
tensor argument on the card is then staged to the host once per fire;
otherwise the descriptor has no argument regions at all.

The pool is reused across fires; every result handed to the schedule
is a COPY out of it (:meth:`NativeXchg._materialize`), so a result from
fire k cannot change when fire k+1 lands other bytes in the pool.

Selection follows the MCA discipline: the ``coll_plan_native`` cvar
plus a capability check — native symbols present, every round peer on
the nativewire card, every send slot frame-templated, every message to
a co-hosted peer within its shm ring (:func:`_check_ring_fit`) — picks
the C executor; anything else falls back to ``PlannedXchg`` unchanged (the
reason is :attr:`SpanningPlanState.why`'s text, and is printed with
``OMPITPU_PLAN_NATIVE_DEBUG=1``). A fire that finds stashed/early
frames or ring-lock contention falls back for THAT fire only
(``plan_native_fallbacks``).

A dead peer during a C fire: the executor returns every ``slice_ms``
and Python runs the ULFM ``check_wait`` between slices, so a peer the
job epoch marks failed, or a revoked cid, surfaces as the usual typed
error within one detection interval. Each plan also hands the executor
a fault word: an ``FtState`` listener raises every live plan's word
when the failure picture changes, the executor stops at its next poll
(``RC_FTSTOP``), and Python runs ``check_wait`` — raising, or clearing
the word and resuming when the change concerns other processes. The
plan's own deadline is its ``wire_coll_timeout_ms`` snapshot (a typed
``ERR_PENDING``), and a ring whose other end is gone reports the typed
``ERR_PROC_FAILED``.

Observability: with obs on, a compile and each C fire are one
``plan``-layer span (``plan_native_compile``, ``plan_native_fire``),
the fire's C-stamped round boundaries land in the flight recorder's
spanning record, and the stall watchdog arms around the C slice loop.
Inline sentinel checking (``obs_sentinel >= 2``) rides ctl frames
between the planned rounds, which the C reap would stash mid-fire: the
executor withdraws then, and ``plan_native_fallbacks`` counts the
withdrawal. So it does while a QoS arbiter is set (``wire_qos_classes``):
a C fire would skip the weighted-fair gate of :meth:`WireRouter._stripe`,
and a bulk tenant's replayed rounds would crowd out the others.
"""
from __future__ import annotations

import ctypes
import os
import struct
import sys
import threading
import time as _time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs as _obs
from ..btl.components import storage_dtype
from ..ft import ulfm as _ulfm
from ..mca import pvar
from ..runtime.wire import _ft
from ..mca import var as mca_var
from ..obs import watchdog as _watchdog
from ..utils.errors import ErrorCode, MPIError
from .plan import _as_nd, check_round

#: bytes held by the per-plan native reassembly pools (the
#: mpool/rcache analogue: sized from the frozen recv metadata at
#: descriptor-compile time, reused across fires)
_pool_bytes = pvar.counter(
    "plan_pool_bytes",
    "bytes preallocated in native plan-executor reassembly pools "
    "(sized from frozen recv metadata, reused across fires)",
)
_pool_hits = pvar.counter(
    "plan_pool_hits",
    "preallocated pool buffers served to native plan fires (each "
    "hit = one reassembly that allocated nothing)",
)
_native_fires = pvar.counter(
    "plan_native_fires",
    "frozen wire plans fired end-to-end by the C executor (one "
    "ctypes slice loop instead of per-round Python orchestration)",
)
_ft_stops = pvar.counter(
    "plan_native_ft_stops",
    "C fires stopped by their raised fault word (a change of the ULFM "
    "failure picture) to run check_wait",
)
_native_fallbacks = pvar.counter(
    "plan_native_fallbacks",
    "native-eligible fires that fell back to the interpreted "
    "PlannedXchg replay for one fire (stashed/early frames, "
    "ring-lock contention), and plans the executor withdrew from "
    "under inline sentinel checking (obs_sentinel >= 2) or a QoS "
    "arbiter (wire_qos_classes set)",
)

_BLOB_MAGIC = 0x314345584C504F  # "OPLXEC1" little-endian
_BLOB_VERSION = 1
_WIN = 16        # provenance-window bytes: unique-match granularity
_SEP = 32        # random separator bytes between arena regions
_SLICE_MS = 100  # the interpreted waits' slice


class _ProbeFail(Exception):
    """Descriptor compile cannot prove byte provenance — the plan
    stays on the interpreted PlannedXchg replay (never an error)."""


class _Ineligible(Exception):
    """Selection gate said no (cvar off, mixed fleet, missing
    symbols, ...) — same graceful withdrawal as :class:`_ProbeFail`,
    but named so the reason says which gate."""


def available() -> bool:
    """True when the loaded .so carries the planexec symbols."""
    try:
        from ..native import bindings as _b

        return bool(_b.planexec_symbols_available())
    except Exception:
        return False


def _nbytes_of(shape, dtype_str) -> int:
    """Bytes of one payload slot; the dtype is a wire name (``bfloat16``
    has no numpy dtype: its storage is ``uint16``)."""
    n = 1
    for d in shape:
        n *= int(d)
    return n * int(storage_dtype(dtype_str).itemsize)


# ---------------------------------------------------------------------------
# probe: run the schedule body wire-free over random bytes
# ---------------------------------------------------------------------------

class _ProbeXchg:
    """Wire-free exchange adapter for the provenance probe: verifies
    each round's structure against the frozen plan, captures the send
    payload bytes in stream order, and hands back the pre-generated
    random receive arrays (the future pool regions)."""

    __slots__ = ("plan", "pools", "i", "payloads")

    def __init__(self, plan, pools: Dict[Tuple[int, int], list]) -> None:
        self.plan = plan
        self.pools = pools
        self.i = 0
        #: per round: payload bytes per message, in (sorted peer,
        #: message-list) order — the blob's stream order
        self.payloads: List[List[bytes]] = []

    def exchange(self, sends: Dict[int, list],
                 recvs: Dict[int, int]) -> Dict[int, list]:
        plan = self.plan
        if self.i >= len(plan.rounds):
            raise _ProbeFail("probe ran more rounds than the plan")
        rnd = plan.rounds[self.i]
        sends_f = {p: [_as_nd(a) for a in arrs]
                   for p, arrs in sends.items() if arrs}
        meta = tuple(
            (p, tuple((a.shape, str(a.dtype)) for a in sends_f[p]))
            for p in sorted(sends_f))
        recvs_t = tuple(sorted((int(p), int(c))
                               for p, c in recvs.items() if int(c) > 0))
        if meta != rnd.sends_meta or recvs_t != rnd.recvs_t:
            raise _ProbeFail("structure diverged under probe inputs")
        pay = []
        for p in sorted(sends_f):
            for a in sends_f[p]:
                pay.append(np.ascontiguousarray(a).tobytes())
        self.payloads.append(pay)
        got = {src: list(self.pools.get((self.i, src), ()))
               for src, _ in rnd.recvs_t}
        self.i += 1
        return got


def _rand_bytes(rng, nb: int) -> np.ndarray:
    """``nb`` random bytes as a fresh uint8 array: the bit generator's
    raw 64-bit words (several times faster than ``Generator.bytes``;
    the probes draw up to a few GiB at 256 MiB per rank)."""
    words = rng.bit_generator.random_raw(-(-nb // 8))
    return words.view(np.uint8)[:nb]


def _rand_array(rng, shape, dtype_str) -> np.ndarray:
    """A host array of random bytes in a wire dtype's storage."""
    nb = _nbytes_of(shape, dtype_str)
    arr = _rand_bytes(rng, nb).view(storage_dtype(dtype_str)).reshape(shape)
    arr.flags.writeable = False  # as a received payload's host view
    return arr


def _rand_like(rng, a):
    """A random-byte stand-in for one schedule argument: a tensor of
    the argument's own dtype on its own device (on the card its bytes
    are drawn there, from a generator seeded off ``rng``), or a host
    array."""
    if isinstance(a, torch.Tensor):
        nb = a.numel() * a.element_size()
        if a.device.type == "cuda":
            gen = torch.Generator(device=a.device)
            gen.manual_seed(int(rng.integers(1 << 62)))
            raw = torch.randint(0, 256, (nb,), dtype=torch.uint8,
                                device=a.device, generator=gen)
        else:
            raw = torch.from_numpy(_rand_bytes(rng, nb))
        return raw.view(a.dtype).reshape(a.shape)
    spec = np.asarray(a)
    return _rand_bytes(rng, spec.nbytes).view(spec.dtype).reshape(
        spec.shape)


def _probe_once(plan, m, fn: Callable, args: Tuple, kw: Dict,
                arg_idx: Tuple[int, ...], seed: int):
    """One wire-free run of the schedule body over random bytes.
    Returns (arg host arrays, pool_list, payloads-per-round)."""
    rng = np.random.default_rng(seed)
    pargs = list(args)
    arg_arrays = []
    for j in arg_idx:
        a = _rand_like(rng, args[j])
        pargs[j] = a
        arg_arrays.append(_as_nd(a))
    pools: Dict[Tuple[int, int], list] = {}
    pool_list: List[np.ndarray] = []
    for i, rnd in enumerate(plan.rounds):
        for src, metas in rnd.recvs_meta:
            lst = [_rand_array(rng, shape, dt) for shape, dt in metas]
            pools[(i, src)] = lst
            pool_list.extend(lst)
    probe = _ProbeXchg(plan, pools)
    old = m._xchg
    m._xchg = probe
    try:
        # random bytes reinterpreted as floats are free to be NaN/inf
        # — only the structure and the raw payload bytes matter here
        with np.errstate(all="ignore"):
            fn(*pargs, **(kw or {}))
    finally:
        m._xchg = old
    if probe.i != len(plan.rounds):
        raise _ProbeFail("probe ran fewer rounds than the plan")
    return arg_arrays, pool_list, probe.payloads


def _build_arena(rng, arg_arrays, pool_list):
    """Concatenate every provenance source region with random
    separators. Returns (arena bytes, sorted region bounds) where a
    bound is (start, end, kind, idx): kind 0 = input region idx
    (positional — args occupy the first input slots), 1 = pool idx."""
    parts: List[bytes] = []
    bounds: List[Tuple[int, int, int, int]] = []
    pos = 0

    def _add(kind: int, idx: int, raw: bytes) -> None:
        nonlocal pos
        sep = rng.bytes(_SEP)
        parts.append(sep)
        pos += _SEP
        parts.append(raw)
        bounds.append((pos, pos + len(raw), kind, idx))
        pos += len(raw)

    for j, a in enumerate(arg_arrays):
        _add(0, j, a.tobytes())
    for k, a in enumerate(pool_list):
        _add(1, k, a.tobytes())
    parts.append(rng.bytes(_SEP))
    return b"".join(parts), bounds


def _region_at(bounds, off: int):
    """The region containing arena offset ``off`` (binary search), or
    None when it falls into a separator gap."""
    lo, hi = 0, len(bounds)
    while lo < hi:
        mid = (lo + hi) // 2
        if bounds[mid][0] <= off:
            lo = mid + 1
        else:
            hi = mid
    if lo == 0:
        return None
    b = bounds[lo - 1]
    return b if off < b[1] else None


def _match_payload(pay: bytes, arena: bytes, a_arr: np.ndarray,
                   bounds) -> Tuple[Tuple[int, int, int, int], ...]:
    """Greedy scatter-gather decomposition of one send payload over
    the arena: 16-byte windows anchor each span, vectorized compare
    extends it, region bounds clamp it. A window appearing in several
    regions (a round-0 send that aliases an argument, say) resolves
    DETERMINISTICALLY — longest matched span, then lowest arena
    offset — so both probe runs pick the same source; the cross-probe
    map-equality check in :func:`_infer_maps` is what proves the pick
    is structural, not a byte coincidence. Anything unprovable is a
    :class:`_ProbeFail` — fallback, never a guess."""
    n = len(pay)
    if n < _WIN:
        raise _ProbeFail("payload too small for provenance windows")
    p_arr = np.frombuffer(pay, dtype=np.uint8)
    segs: List[Tuple[int, int, int, int]] = []
    pos = 0
    while pos < n:
        if n - pos < _WIN:
            raise _ProbeFail("unmatchable payload tail")
        w = pay[pos:pos + _WIN]
        best = None  # (mlen, -off) maximized
        off = arena.find(w)
        if off < 0:
            raise _ProbeFail("payload bytes not found in any region")
        while off >= 0:
            reg = _region_at(bounds, off)
            if reg is not None and off + _WIN <= reg[1]:
                lim = min(n - pos, reg[1] - off)
                d = np.flatnonzero(
                    a_arr[off:off + lim] != p_arr[pos:pos + lim])
                mlen = int(d[0]) if d.size else lim
                if mlen >= _WIN and (best is None or mlen > best[0]):
                    best = (mlen, off, reg)
            off = arena.find(w, off + 1)
        if best is None:
            raise _ProbeFail("window matches no whole region span")
        mlen, off, reg = best
        start, _end, kind, idx = reg
        prev = segs[-1] if segs else None
        if (prev is not None and prev[0] == kind and prev[1] == idx
                and prev[2] + prev[3] == off - start):
            segs[-1] = (kind, idx, prev[2], prev[3] + mlen)
        else:
            segs.append((kind, idx, off - start, mlen))
        pos += mlen
    return tuple(segs)


def _infer_maps(plan, m, fn, args, kw, arg_idx):
    """Byte-provenance maps for every round >= 1 send message, proven
    identical across two independently-seeded probes. A one-round plan
    sends its round-0 arrays verbatim: there is nothing to locate, and
    its structure is checked on every fire anyway (each replayed round
    against the plan, each inbound header against its frozen template
    in C), so it runs no probe."""
    if len(plan.rounds) == 1:
        return (None,)
    results = []
    for seed in (0x5EED01 ^ (plan.cid & 0xFFFF),
                 0x5EED02 ^ (plan.cid & 0xFFFF)):
        arg_arrays, pool_list, payloads = _probe_once(
            plan, m, fn, args, kw, arg_idx, seed)
        # round-0 payload count has to match the stream order BEFORE
        # the arena is laid out: those payloads are input regions
        n0 = sum(len(a) for _, a in plan.rounds[0].sends_meta)
        if len(payloads[0]) != n0:
            raise _ProbeFail("round-0 message count diverged")
        rng = np.random.default_rng(seed ^ 0xA5A5A5)
        # provenance sources = args, then the round-0 send payloads
        # (same order as the C input-region table: a later round may
        # resend a locally-folded partial no argument ever held),
        # then every pool buffer
        inputs = list(arg_arrays) + [
            np.frombuffer(p, dtype=np.uint8) for p in payloads[0]]
        arena, bounds = _build_arena(rng, inputs, pool_list)
        a_arr = np.frombuffer(arena, dtype=np.uint8)
        maps: List[Optional[Tuple]] = [None]  # round 0 is identity
        for r in range(1, len(plan.rounds)):
            maps.append(tuple(_match_payload(p, arena, a_arr, bounds)
                              for p in payloads[r]))
        results.append(tuple(maps[1:]))
    if results[0] != results[1]:
        raise _ProbeFail("independent probes inferred different maps")
    return (None,) + results[0]


# ---------------------------------------------------------------------------
# descriptor compile: plan + maps -> flat C blob
# ---------------------------------------------------------------------------

def _align8(n: int) -> int:
    return (n + 7) & ~7


def build_blob(tag: int, input_lens, pool_sizes, peer_pidx,
               rounds) -> bytes:
    """Serialize the flat descriptor table ``planexec_create``
    consumes (all fields little-endian int64; byte fields carry an
    int64 length prefix). ``rounds`` entries are dicts with ``depth``,
    ``streams`` = [(peer_idx, [msg...])] where a send msg is
    (pre, mid, nbytes, nchunks, chunk, segs) and segs are
    (kind, idx, off, len); ``rsrcs`` = [(peer_idx, [recv msg...])]
    where a recv msg is (pool_idx, nbytes, nchunks, chunk, pre, mid).
    Module-level, so a test compiles a descriptor table with no job."""
    out = bytearray()

    def w(v: int) -> None:
        out.extend(struct.pack("<q", int(v)))

    def wb(b: bytes) -> None:
        w(len(b))
        out.extend(b)

    w(_BLOB_MAGIC)
    w(_BLOB_VERSION)
    w(tag)
    w(len(input_lens))
    for n in input_lens:
        w(n)
    off = 0
    offs = []
    for n in pool_sizes:
        offs.append(off)
        off = _align8(off + n)
    w(len(pool_sizes))
    for o, n in zip(offs, pool_sizes):
        w(o)
        w(n)
    w(off)  # pool_total
    w(len(peer_pidx))
    for p in peer_pidx:
        w(p)
    w(len(rounds))
    for rd in rounds:
        w(rd["depth"])
        w(len(rd["streams"]))
        for peer_idx, msgs in rd["streams"]:
            w(peer_idx)
            w(len(msgs))
            for pre, mid, nbytes, nchunks, chunk, segs in msgs:
                wb(pre)
                wb(mid)
                w(nbytes)
                w(nchunks)
                w(chunk)
                w(len(segs))
                for kind, idx, so, sl in segs:
                    w(kind)
                    w(idx)
                    w(so)
                    w(sl)
        w(len(rd["rsrcs"]))
        for peer_idx, msgs in rd["rsrcs"]:
            w(peer_idx)
            w(len(msgs))
            for pool_idx, nbytes, nchunks, chunk, pre, mid in msgs:
                w(pool_idx)
                w(nbytes)
                w(nchunks)
                w(chunk)
                wb(pre)
                wb(mid)
    return bytes(out)




class NativePlan:
    """One compiled-and-bound native executor: the C descriptor table
    handle, the fire-time layout (input specs, per-round pool
    placements), the ring/lock bindings, and precomputed pvar totals
    so the MPI_T series never dip when the C path engages."""

    __slots__ = (
        "gen", "px", "cid", "tag", "peers", "arg_idx", "arg_specs",
        "r0_specs", "pool_rounds", "timeout_ms", "ftword", "router",
        "rx_entries", "fire_locks", "send_msgs", "send_bytes",
        "recv_msgs", "recv_bytes", "send_frames", "recv_frames",
        "xfer_total", "pool_count", "pool_total", "busy", "__weakref__",
    )

    def close(self) -> None:
        """Destroy the executor and free its reassembly pool — after a
        fire in flight on another thread has returned (a revoke drops
        the plans from the FT watcher's thread; the fire sees the
        raised fault word and stops within a slice)."""
        with self.busy:
            px, self.px = self.px, None
            _live.discard(self)
        if px is not None:
            px.close()


#: every bound executor's plan: the FT listener raises their fault words
_live: "weakref.WeakSet[NativePlan]" = weakref.WeakSet()


def _raise_fault_words(_doc) -> None:
    """``FtState`` listener: the failure picture changed — stop every
    running C fire at its next poll so Python re-checks it."""
    for npl in list(_live):
        npl.ftword[0] = 1


_ulfm.state().add_listener(_raise_fault_words)


def _check_ring_fit(plan, nw) -> None:
    """Withdraw a plan whose message to or from a co-hosted peer is
    larger than the shm ring between them. The C executor's ring leg
    waits 5 ms each time a fragment meets a full ring before it reaps
    its own arrivals (``native/planexec.cc`` ``send_frag``), so such a
    message crossed two to four times slower in C than through
    ``PlannedXchg`` on an H100 (``chip_smoke.py``'s slice 11, then with
    the Python sender moving a full ring's remainder over the socket);
    within the ring, C wins. A message within the ring must also fit
    its largest fragment's ring record (the payload, the SGC2 prefix
    and the ring's length and tag): a record larger than the ring can
    never be written there, and the C fire would wait on it forever."""
    from ..btl.nativewire import _RING_RECORD_OVERHEAD

    seg = int(nw.pipeline_segsize())
    biggest: Dict[int, int] = {}
    for rnd in plan.rounds:
        for p, arrs in rnd.sends_meta:
            for shape, dt in arrs:
                biggest[p] = max(biggest.get(p, 0), _nbytes_of(shape, dt))
        for src, metas in rnd.recvs_meta:
            for shape, dt in metas:
                biggest[src] = max(biggest.get(src, 0),
                                   _nbytes_of(shape, dt))
    for p, nb in sorted(biggest.items()):
        if not nw._same_host(p):
            continue
        cap = min(nw._cap(p)[2], nw._cap(nw.my_pidx)[2])
        if nb > cap:
            raise _Ineligible(f"a {nb}-byte message to or from process "
                              f"{p} exceeds the {cap}-byte shm ring")
        rec = (min(nb, seg) if seg > 0 else nb) + _RING_RECORD_OVERHEAD
        if rec > cap:
            raise _Ineligible(f"a {rec}-byte fragment record to or from "
                              f"process {p} exceeds the {cap}-byte shm "
                              "ring")


def try_compile(state, m, fn: Callable, args: Tuple,
                kw: Optional[Dict]):
    """Lower ``state.plan`` into a bound :class:`NativePlan`, or None
    when anything — cvar off, missing symbols, a non-native peer, an
    unprovable byte map — says the interpreted replay should keep the
    plan; ``state.why`` then names the gate. Never raises:
    ineligibility is a selection outcome."""
    t0 = _time.perf_counter()
    try:
        npl = _compile(state, m, fn, args, kw or {})
        state.why = None
        if _obs.enabled:
            _obs.record("plan_native_compile", "plan", t0,
                        _time.perf_counter() - t0,
                        comm_id=state.comm.cid)
        return npl
    except Exception as e:
        state.why = f"{type(e).__name__}: {e}"
        if os.environ.get("OMPITPU_PLAN_NATIVE_DEBUG"):
            import traceback

            print(f"[native_exec] withdrew: {e!r}", file=sys.stderr)
            traceback.print_exc()
        return None


def _sentinel_level() -> int:
    try:
        return int(mca_var.get("obs_sentinel", 0) or 0)
    except Exception:
        return 0


def _compile(state, m, fn, args, kw):
    plan = state.plan
    if plan is None or not plan.rounds:
        raise _Ineligible("no frozen plan")
    if not bool(mca_var.get("coll_plan_native", True)):
        raise _Ineligible("coll_plan_native=0")
    if _sentinel_level() >= 2:
        # inline sentinel checking rides ctl frames interleaved with
        # the planned rounds — the C reap would stash them mid-fire
        _native_fallbacks.add()
        raise _Ineligible("inline sentinel level >= 2")
    if not available():
        raise _Ineligible("planexec symbols absent")
    router = getattr(m, "router", None)
    nw = getattr(router, "_nw", None)
    if router is None or nw is None:
        raise _Ineligible("no nativewire btl")
    tuning = router.tuning()
    if tuning.arbiter is not None:
        # the QoS arbiter owns pacing: a C fire would skip its
        # weighted-fair gate, so replays stay on PlannedXchg
        _native_fallbacks.add()
        raise _Ineligible("qos arbiter active")
    comm = state.comm

    # argument regions: every positional array arg is a candidate
    # input region
    arg_idx = []
    arg_specs = []
    for j, a in enumerate(args):
        if hasattr(a, "shape") and hasattr(a, "dtype"):
            spec = _as_nd(a) if not isinstance(a, torch.Tensor) else None
            nb = (a.numel() * a.element_size() if spec is None
                  else int(spec.nbytes))
            if nb <= 0:
                raise _Ineligible("zero-byte array arg")
            arg_idx.append(j)
            arg_specs.append((tuple(a.shape), str(a.dtype), nb))
    for v in (kw or {}).values():
        if hasattr(v, "shape") and hasattr(v, "dtype"):
            raise _Ineligible("keyword array args not lowered")
    arg_idx = tuple(arg_idx)

    # capability + structure gate over every round
    send_peers = set()
    recv_srcs = set()
    for rnd in plan.rounds:
        metas = getattr(rnd, "recvs_meta", None)
        if metas is None:
            raise _Ineligible("plan has no arrival metas")
        by_src = dict(metas)
        for src, cnt in rnd.recvs_t:
            lst = by_src.get(src)
            if lst is None or len(lst) != cnt:
                raise _Ineligible("arrival metas disagree with recvs")
            recv_srcs.add(src)
            for shape, dt in lst:
                if _nbytes_of(shape, dt) <= 0:
                    raise _Ineligible("zero-byte receive")
        for (p, arrs), (_p2, tpls) in zip(rnd.sends_meta,
                                          rnd.peer_slots):
            send_peers.add(p)
            if len(arrs) != len(tpls) or any(t is None for t in tpls):
                raise _Ineligible("untemplated send slot")
            for shape, dt in arrs:
                if _nbytes_of(shape, dt) <= 0:
                    raise _Ineligible("zero-byte send")
    peers = tuple(sorted(send_peers | recv_srcs))
    if not peers:
        raise _Ineligible("no wire peers")
    for p in peers:
        if router._btl_for(p) is not nw:
            raise _Ineligible(f"peer {p} not on nativewire")
    _check_ring_fit(plan, nw)
    # byte-provenance probe (two seeds, identical maps required)
    maps = _infer_maps(plan, m, fn, args, kw, arg_idx)

    seg = min(tuning.segsize, max(1, nw.max_send_size))
    from ..btl.components import plan_frame_template

    # argument regions are handed to C only when a map reads one (a
    # card tensor would otherwise be staged to the host per fire for
    # nothing); unread, the table starts at the round-0 sends
    n_args = len(arg_specs)
    used_args = any(kind == 0 and idx < n_args
                    for rmap in maps[1:] for segs in rmap
                    for kind, idx, _so, _sl in segs)
    shift = 0 if used_args else n_args
    if not used_args:
        arg_idx, arg_specs = (), []
        maps = (None,) + tuple(
            tuple(tuple((kind, idx - n_args if kind == 0 else idx, so,
                         sl) for kind, idx, so, sl in segs)
                  for segs in rmap)
            for rmap in maps[1:])
    n_in_args = n_args - shift

    # input regions: args (when read), then round-0 send arrays in
    # stream order (later rounds may resend round-0 bytes that no arg
    # holds)
    input_lens = [nb for _s, _d, nb in arg_specs]
    r0_specs = []
    for p, arrs in plan.rounds[0].sends_meta:
        for shape, dt in arrs:
            nb = _nbytes_of(shape, dt)
            r0_specs.append((p, tuple(shape), dt, nb))
            input_lens.append(nb)

    # pool layout: one buffer per (round, sorted src, message), at
    # the same 8-aligned cumulative offsets build_blob will emit
    pool_sizes: List[int] = []
    pool_round: List[int] = []
    pool_off = 0
    pool_rounds = []  # per round: [(src, [(idx, off, shape, dt, nb)])]
    for i, rnd in enumerate(plan.rounds):
        per_src = []
        for src, metas in sorted(dict(rnd.recvs_meta).items()):
            lst = []
            for shape, dt in metas:
                nb = _nbytes_of(shape, dt)
                lst.append((len(pool_sizes), pool_off, tuple(shape),
                            storage_dtype(dt), nb))
                pool_sizes.append(nb)
                pool_round.append(i)
                pool_off = _align8(pool_off + nb)
            per_src.append((src, lst))
        pool_rounds.append(per_src)

    peer_index = {p: i for i, p in enumerate(peers)}
    send_msgs = send_bytes = send_frames = 0
    recv_msgs = recv_bytes = recv_frames = 0
    rounds_desc = []
    for i, rnd in enumerate(plan.rounds):
        streams = []
        flat = 0  # message index within the round, stream order
        for (p, arrs), (_p2, tpls) in zip(rnd.sends_meta,
                                          rnd.peer_slots):
            msgs = []
            for (shape, dt), tpl in zip(arrs, tpls):
                nb = _nbytes_of(shape, dt)
                if i == 0:
                    segs = ((0, n_in_args + flat, 0, nb),)
                else:
                    segs = maps[i][flat]
                    tot = 0
                    for kind, idx, _so, sl in segs:
                        tot += sl
                        if kind == 1 and pool_round[idx] >= i:
                            # provenance from a not-yet-filled pool
                            # buffer can only be coincidence
                            raise _ProbeFail("acausal provenance")
                    if tot != nb:
                        raise _ProbeFail("map does not cover payload")
                msgs.append((tpl.pre, tpl.mid, nb, int(tpl.nchunks),
                             int(tpl.chunk), segs))
                send_msgs += 1
                send_bytes += nb
                send_frames += int(tpl.nchunks) + 1
                flat += 1
            streams.append((peer_index[p], msgs))
        rsrcs = []
        for src, lst in pool_rounds[i]:
            msgs = []
            metas = dict(rnd.recvs_meta)[src]
            for (pool_idx, _off, shape, _dt, nb), (_s, dname) in zip(
                    lst, metas):
                tpl = plan_frame_template(shape, dname, seg)
                msgs.append((pool_idx, nb, int(tpl.nchunks),
                             int(tpl.chunk), tpl.pre, tpl.mid))
                recv_msgs += 1
                recv_bytes += nb
                recv_frames += int(tpl.nchunks) + 1
            rsrcs.append((peer_index[src], msgs))
        rounds_desc.append({"depth": int(rnd.depth),
                            "streams": streams, "rsrcs": rsrcs})

    blob = build_blob(plan.rounds[0].tag, input_lens, pool_sizes,
                      peers, rounds_desc)
    from ..native import bindings as _b

    px = _b.PlanExec(blob)

    # bind the live endpoint + ring handles once (rings exist after
    # the recording fire; a missing tx ring means the socket leg)
    handles = nw.plan_endpoints(plan.rounds[0].tag,
                                sorted(send_peers),
                                sorted(recv_srcs))
    tx_h, rx_h, rx_entries, fire_locks = [], [], {}, []
    for p in peers:
        tx, rx = handles[p]
        tx_h.append(tx[0]._h if tx is not None else None)
        rx_h.append(rx[0]._h if rx is not None else None)
        if tx is not None:
            fire_locks.append((p, 0, tx[1]))
        if rx is not None:
            fire_locks.append((p, 1, rx[1]))
            rx_entries[p] = rx
    # raised by the FT listener on every change of the failure picture
    word = (ctypes.c_int64 * 1)(0)
    px.bind(router.ep._h, router._nid(m.my_pidx),
            [router._nid(p) for p in peers], tx_h, rx_h)
    px.set_ftword(word)

    npl = NativePlan()
    npl.gen = plan.gen
    npl.px = px
    npl.cid = comm.cid
    npl.tag = plan.rounds[0].tag
    npl.peers = peers
    npl.arg_idx = arg_idx
    npl.arg_specs = tuple(arg_specs)
    npl.r0_specs = tuple(r0_specs)
    npl.pool_rounds = pool_rounds
    npl.timeout_ms = plan.timeout_ms
    npl.ftword = word
    npl.router = router
    npl.rx_entries = rx_entries
    npl.fire_locks = sorted(fire_locks, key=lambda e: (e[0], e[1]))
    npl.send_msgs = send_msgs
    npl.send_bytes = send_bytes
    npl.recv_msgs = recv_msgs
    npl.recv_bytes = recv_bytes
    npl.send_frames = send_frames
    npl.recv_frames = recv_frames
    npl.xfer_total = max(1, send_msgs)
    npl.pool_count = len(pool_sizes)
    npl.pool_total = px.pool_total
    npl.busy = threading.Lock()
    _pool_bytes.add(npl.pool_total)
    _live.add(npl)
    return npl


# ---------------------------------------------------------------------------
# fire: the per-replay exchange adapter
# ---------------------------------------------------------------------------

class NativeXchg:
    """Exchange adapter that fires the WHOLE plan C-side on its first
    round: round-0 sends come verbatim from the arrays the schedule
    just passed, later rounds compose from the proven byte-provenance
    maps, receives reassemble into the plan pool. Rounds >= 1 only
    verify structure and hand back pool copies. Any per-fire safety
    veto (stashed frames, lock contention) delegates the entire fire
    to a fresh :class:`~.plan.PlannedXchg` — same plan, same bytes.
    ``fired`` says whether the C executor ran this fire."""

    __slots__ = ("m", "plan", "np", "i", "ts", "args", "_delegate",
                 "_pool", "_c_wait", "fired")

    def __init__(self, module, plan, npl: NativePlan,
                 args: Tuple) -> None:
        self.m = module
        self.plan = plan
        self.np = npl
        self.i = 0
        #: round-end clock reads for the flight recorder (the C
        #: executor stamps them); None = unobserved fire
        self.ts: Optional[List[float]] = None
        self.args = args
        self._delegate = None
        self._pool = None
        #: seconds spent blocked in the C slice loop during the last
        #: exchange — wire-transport time, subtracted from the
        #: orchestration self-report
        self._c_wait = 0.0
        self.fired = False

    def exchange(self, sends: Dict[int, list],
                 recvs: Dict[int, int]) -> Dict[int, list]:
        if self._delegate is not None:
            return self._delegate.exchange(sends, recvs)
        t0 = _time.perf_counter()
        self._c_wait = 0.0
        try:
            return self._exchange(sends, recvs)
        finally:
            if self._delegate is None:
                # a fire that fell back mid-call accounted itself
                # through the delegate's PlannedXchg.exchange
                from . import driver as _driver

                _driver._orch.add(
                    max(0.0, _time.perf_counter() - t0 - self._c_wait))

    def _exchange(self, sends: Dict[int, list],
                  recvs: Dict[int, int]) -> Dict[int, list]:
        _rnd, sends_f = check_round(self.m, self.plan, self.i, sends,
                                    recvs)
        if self.i == 0 and not self._fire(sends_f):
            _native_fallbacks.add()
            from .plan import PlannedXchg

            dg = PlannedXchg(self.m, self.plan)
            dg.ts = self.ts
            self._delegate = dg
            return dg.exchange(sends, recvs)
        got = self._materialize(self.i)
        self.i += 1
        return got

    # -- fire-time plumbing ------------------------------------------------
    def _contig(self, a: np.ndarray) -> np.ndarray:
        if a.flags.c_contiguous:
            return a
        from ..btl.nativewire import _fallback_copies

        _fallback_copies.add()
        return np.ascontiguousarray(a)

    def _inputs(self, sends_f) -> Optional[List[np.ndarray]]:
        npl = self.np
        out = []
        for j, (shape, dt, _nb) in zip(npl.arg_idx, npl.arg_specs):
            a = self.args[j]
            if tuple(a.shape) != shape or str(a.dtype) != dt:
                return None
            out.append(self._contig(_as_nd(a)))
        flat: List[np.ndarray] = []
        for p in sorted(sends_f):
            flat.extend(sends_f[p])
        if len(flat) != len(npl.r0_specs):
            return None
        for a in flat:
            out.append(self._contig(a))
        return out

    def _clean_channel(self) -> bool:
        """True when no stashed/early frame could race the C reap."""
        npl = self.np
        router = npl.router
        cid = npl.cid
        with router._coll_early_lock:
            for (c, _src), q in router._coll_early.items():
                if c == cid and q:
                    return False
        from ..btl.components import _ep_stash

        stash, lock = _ep_stash(router.ep)
        with lock:
            for p in npl.peers:
                if stash.get((router._nid(p), npl.tag)):
                    return False
        return True

    def _fire(self, sends_f) -> bool:
        t0 = _time.perf_counter()
        npl = self.np
        router = npl.router
        inputs = self._inputs(sends_f)
        if inputs is None:
            return False
        held: List[threading.Lock] = []
        if not npl.busy.acquire(blocking=False):
            return False
        held.append(npl.busy)
        if npl.px is None:  # dropped by a revoke since the replay began
            npl.busy.release()
            return False
        chan = router._chan_lock("collrx", npl.cid)
        if not chan.acquire(blocking=False):
            npl.busy.release()
            return False
        held.append(chan)
        fired = False
        epoch0 = getattr(self.m.comm, "_ft_epoch0", 0)
        try:
            for _p, _kind, lk in npl.fire_locks:
                if not lk.acquire(blocking=False):
                    return False
                held.append(lk)
            if not self._clean_channel():
                return False
            for _src, (_ring, _lk, rstash) in npl.rx_entries.items():
                if rstash.get(npl.tag):
                    return False
            _ft().check_wait(npl.cid, npl.peers, "native plan fire",
                             epoch0=epoch0)
            from ..btl import components as _btlc

            base = next(_btlc._xfer_ids)
            for _ in range(npl.xfer_total - 1):
                next(_btlc._xfer_ids)
            npl.ftword[0] = 0
            px = npl.px
            if px.fire_begin(inputs, base, npl.timeout_ms) != 0:
                return False
            fired = True
            self._run(px, npl, epoch0)
            self._harvest(px, npl, t0)
            self.fired = True
            return True
        finally:
            if fired:
                # the rx entry locks are still held here — the
                # restash below needs them
                self._drain_stash(npl)
            for lk in reversed(held):
                lk.release()

    def _run(self, px, npl: NativePlan, epoch0: int) -> None:
        tok = None
        if _watchdog.enabled:
            tok = _watchdog.arm(
                "native_plan_fire", comm_id=npl.cid,
                info=lambda n=npl: {"peers": list(n.peers),
                                    "rounds": len(n.pool_rounds)})
        t_w = _time.perf_counter()
        try:
            while True:
                rc = px.fire_step(_SLICE_MS)
                if rc == px.RC_DONE:
                    return
                if rc in (px.RC_AGAIN, px.RC_FTSTOP):
                    if rc == px.RC_FTSTOP:
                        _ft_stops.add()
                    # the detection interval: a dead member process or
                    # a revoked cid surfaces typed; a change that
                    # concerns other processes clears the word and the
                    # fire resumes where it stopped
                    _ft().check_wait(npl.cid, npl.peers,
                                     "native plan fire", epoch0=epoch0)
                    npl.ftword[0] = 0
                    continue
                self._raise_rc(px, npl, rc)
        finally:
            self._c_wait = _time.perf_counter() - t_w
            if tok is not None:
                _watchdog.disarm(tok)

    def _raise_rc(self, px, npl: NativePlan, rc: int) -> None:
        name = self.m.comm.name
        if rc == px.RC_PEERDEAD:
            pidx = px.err_peer()  # the C side stores the pidx
            raise MPIError(
                ErrorCode.ERR_PROC_FAILED,
                f"native plan fire on {name} depends on process "
                f"{pidx}, which the wire reports dead "
                f"(round {px.err_round()})",
            )
        if rc == px.RC_TIMEOUT:
            raise MPIError(
                ErrorCode.ERR_PENDING,
                f"native plan fire on {name} timed out after "
                f"{npl.timeout_ms} ms (round {px.err_round()})",
            )
        if rc == px.RC_DIVERGED:
            from .plan import _mismatch

            raise _mismatch(
                self.m, self.i,
                "an inbound header did not match the frozen frame "
                "template (peer re-planned or cvars differ across "
                "ranks)")
        if rc == px.RC_TRUNCATED:
            raise MPIError(
                ErrorCode.ERR_TRUNCATE,
                "native plan fire: reassembled payload failed its "
                f"CRC (round {px.err_round()})",
            )
        raise MPIError(ErrorCode.ERR_INTERN,
                       f"native plan executor returned rc {rc}")

    def _drain_stash(self, npl: NativePlan) -> None:
        """Re-inject frames the C reap popped but does not own into
        the shared Python stashes (kind 0 = endpoint frame, kind 1 =
        ring record) — the portable consumers find them exactly where
        the interpreted path would have stashed them."""
        entries = npl.px.drain_stash()
        if not entries:
            return
        from ..btl.components import _ep_stash
        from ..btl.nativewire import _fallback_copies

        router = npl.router
        for kind, pidx, tag, raw in entries:
            if kind == 1 and pidx in npl.rx_entries:
                _ring, _lk, rstash = npl.rx_entries[pidx]
                # caller already holds the rx entry lock
                rstash.setdefault(tag, []).append(raw)
                _fallback_copies.add()  # the one restash copy
            else:
                stash, lock = _ep_stash(router.ep)
                with lock:
                    stash.setdefault((router._nid(pidx), tag),
                                     []).append(raw)

    def _harvest(self, px, npl: NativePlan, t0: float) -> None:
        self._pool = px.pool_view()
        if self.ts is not None:
            self.ts[:] = px.round_ts()
        # pvar continuity: the C fire IS these sends/recvs — MPI_T
        # series must not dip when the native executor engages. Frame
        # counts mirror the interpreted path exactly: chunk pvars
        # count fragments (not headers), _native_frames counts send
        # fragments.
        from . import hier as _hier

        _hier._inter_msgs_sent.add(npl.send_msgs)
        _hier._inter_bytes.add(npl.send_bytes)
        _hier._inter_msgs_recvd.add(npl.recv_msgs)
        from ..btl import nativewire as _nw

        _nw._native_bytes.add(npl.send_bytes + npl.recv_bytes)
        _nw._native_frames.add(npl.send_frames - npl.send_msgs)
        _nw._zero_copy_strict.add(npl.send_bytes + npl.recv_bytes)
        btl = npl.router._nw
        if btl is not None:
            btl.staged_chunks_pvar.add(
                (npl.send_frames - npl.send_msgs)
                + (npl.recv_frames - npl.recv_msgs))
            btl.staged_bytes_pvar.add(npl.send_bytes + npl.recv_bytes)
        _pool_hits.add(npl.pool_count)
        _native_fires.add()
        if _obs.enabled:
            _obs.record("plan_native_fire", "plan", t0,
                        _time.perf_counter() - t0, comm_id=npl.cid)

    def _materialize(self, r: int) -> Dict[int, list]:
        """Round ``r``'s arrivals as fresh host arrays COPIED out of
        the pool (the pool is overwritten by the next fire; a result
        must never alias it)."""
        npl = self.np
        pool = self._pool
        got: Dict[int, list] = {}
        for src, lst in npl.pool_rounds[r]:
            arrs = []
            for _pool_idx, off, shape, dt, nb in lst:
                a = np.empty(shape, dtype=dt)
                a.reshape(-1).view(np.uint8)[:] = pool[off:off + nb]
                arrs.append(a)
            got[src] = arrs
        return got
