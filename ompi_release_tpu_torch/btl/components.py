"""btl components: self / ici / shm / dcn / host (counterpart of
``ompi_release_tpu/btl/components.py``).

Mapping from the reference's transport zoo (``ompi/mca/btl/``):

  self  loopback (``btl/self``)               -> same-rank no-op
  ici   the in-card pair (``btl/sm``/``btl/vader`` role: the fast,
        always-there local fabric)            -> a device copy inside
        this process (virtual ranks share one H100; ``.to(device)``
        between two cards of one process)
  shm   intra-host CROSS-PROCESS handoff      -> one POSIX shm segment
        per payload, control frame on the OOB
  dcn   inter-host network (``btl/tcp`` role) -> chunked OOB staging
  host  explicit host-memory staging bounce (the ``btl/smcuda`` host
        path)                                 -> device→host→device

Reachability uses the modex endpoint records (slice_index /
process_index / host — the business-card fields), exactly how
add_procs decides per-peer BTL eligibility (``btl.h:810-816``).

Host staging: the cross-process transports carry host bytes. A CUDA
payload is copied to the host with a blocking copy (the stream is
synchronized, so the bytes are final) before they enter a segment or a
socket, and a received payload is rebuilt as a host tensor, moved to
``dst_device`` with a blocking copy when the caller names one. bf16
crosses as raw 2-byte words with ``bfloat16`` as its dtype in the
header (numpy has no bf16); every other dtype travels under its numpy
name, so the frames are byte-identical to the JAX package's.
"""

from __future__ import annotations

import itertools
import os
import threading
import time as _time
import uuid

import numpy as np
import torch

from .. import obs as _obs
from ..mca import component as mca_component
from ..mca import pvar as _pvar
from ..mca import var as mca_var
from ..native import USER_TAG_BASE
from ..utils.errors import ErrorCode, MPIError
from . import base

#: frame magics: every staged frame self-identifies, so a receiver that
#: timed out mid-transfer (leaving orphan chunks queued/stashed) can
#: resynchronize — unknown or stale frames are discarded, never parsed
#: as a header or delivered to the wrong transfer
_HDR_MAGIC = "SGH1"
_CHUNK_MAGIC = b"SGC1"
#: pipelined staged framing (``wire_pipeline_segsize`` > 0): chunks
#: carry an explicit fragment index so the receiver reassembles into a
#: PREALLOCATED buffer at ``idx * segsize`` (no join copy) and a late
#: or reordered fragment still lands at its own offset
_HDR2_MAGIC = "SGH2"
_CHUNK2_MAGIC = b"SGC2"
_xfer_ids = itertools.count(1)

#: the zero-copy ledger, split honestly: ``strict`` counts bytes that
#: never touched a Python-side copy at all (nativewire vectored
#: writev / shm-ring memcpy / dlpack handoff); ``sliced`` counts bytes
#: that moved as memoryview slices or preallocated-buffer views — one
#: staging copy at the OOB boundary, no whole-array ``tobytes()``.
#: The historical name ``wire_bytes_zero_copy`` (which used to count
#: the sliced discipline) stays as a summing alias, the same way
#: ``hier_inter_msgs`` aliases its sent+recvd split.
_zero_copy_strict = _pvar.counter(
    "wire_bytes_zero_copy_strict",
    "payload bytes moved with no Python-side copy at all: vectored "
    "writev straight from the source buffer, shm-ring transfers into "
    "the preallocated reassembly buffer (the nativewire datapath)",
)
_sliced_bytes = _pvar.counter(
    "wire_bytes_sliced",
    "payload bytes shipped as memoryview slices over the source "
    "buffer or landed in preallocated-buffer views instead of "
    "whole-array copies (one staging copy at the OOB boundary)",
)
_zero_copy_bytes = _pvar.PVARS.register(
    "wire_bytes_zero_copy", _pvar.PvarClass.COUNTER,
    "zero-copy-discipline wire bytes "
    "(alias: wire_bytes_zero_copy_strict + wire_bytes_sliced)",
    getter=lambda: _zero_copy_strict.read() + _sliced_bytes.read(),
)
_frags_inflight = _pvar.highwatermark(
    "wire_frags_inflight",
    "high watermark of pipeline fragments announced but not yet "
    "reassembled for a single staged transfer",
)


def register_pipeline_vars() -> None:
    """Wire-pipeline cvars live HERE (the transport that reads them)
    so any staged-path user — the wire router, tpu-tune's loopback
    sweep, a bare DcnBtl — sees them registered; runtime/wire.py
    re-exports through its own register_vars."""
    mca_var.register(
        "wire_pipeline_segsize", "size", 1 << 20,
        "Bytes per in-flight wire fragment for cross-process payloads "
        "(the ob1 RNDV pipeline's fragment size): payloads cross as "
        "zero-copy memoryview slices reassembled into a preallocated "
        "receive buffer; 0 restores the legacy single-pass tobytes() "
        "framing",
    )
    mca_var.register(
        "wire_pipeline_depth", "int", 4,
        "Fragments enqueued per destination per round-robin turn when "
        "one exchange posts transfers to several peers (the sliding "
        "in-flight window of coll_send_all striping)",
    )


register_pipeline_vars()  # idempotent; read on every staged send


def payload_nbytes(data) -> int:
    """Bytes of a payload (a tensor, a host array, or None) off its
    metadata: no copy, no device sync — what the obs emit sites
    record."""
    if hasattr(data, "element_size"):
        return int(data.numel()) * int(data.element_size())
    return int(getattr(data, "nbytes", 0) or 0)


def _check_user_tag(tag: int) -> None:
    if tag < USER_TAG_BASE:
        raise MPIError(
            ErrorCode.ERR_TAG,
            f"transport payload tags start at {USER_TAG_BASE} (below "
            "is the coordinator/pubsub control plane — a staged frame "
            "there would be consumed as a control frame)",
        )


#: the wire name of bf16 (numpy has none: the payload is its raw
#: 2-byte words, stored host-side as uint16)
BF16 = "bfloat16"


def host_payload(data):
    """``(contiguous host numpy array, wire dtype name)`` for one
    payload. A tensor on the card is copied to the host with a
    blocking copy — the bytes are complete before they are read; a
    host tensor or numpy array is viewed without a copy where it is
    already contiguous."""
    if isinstance(data, torch.Tensor):
        t = data.detach()
        if t.device.type != "cpu":
            t = t.to("cpu")  # blocking: synchronizes the stream
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.ascontiguousarray(np.asarray(data))
    return arr, str(arr.dtype)


def storage_dtype(name: str) -> np.dtype:
    """The numpy dtype that holds a wire dtype's bytes on the host."""
    return np.dtype(np.uint16) if name == BF16 else np.dtype(name)


def host_tensor(arr: np.ndarray, name: str, dst_device=None):
    """Rebuild a received payload as a tensor: on the host, or moved
    to ``dst_device`` with a blocking copy (the host buffer may be
    reused as soon as this returns)."""
    if not arr.flags.writeable:
        arr = arr.copy()
    if name == BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if dst_device is not None and torch.device(dst_device).type != "cpu":
        t = t.to(dst_device)
    return t


def _pack_dtype_shape(buf, dtype, shape) -> None:
    """THE array-metadata wire format (dtype string, comma-joined
    shape) — single definition, so staged/shm headers and the
    plan-time :class:`FrameTemplate` can never desynchronize."""
    buf.pack_string(str(dtype))
    buf.pack_string(",".join(str(d) for d in shape))


def _pack_array_header(buf, arr: np.ndarray, dtype_name: str,
                       *extra_front) -> None:
    """Array-metadata wire format shared by the staged (DCN) and shm
    transports: [*extra_front,] dtype, comma-joined shape."""
    for f in extra_front:
        buf.pack_string(f)
    _pack_dtype_shape(buf, dtype_name, arr.shape)


def _unpack_array_header(buf):
    """Returns (wire dtype name, shape) from the shared wire format."""
    dtype = buf.unpack_string()
    shape_s = buf.unpack_string()
    shape = tuple(int(d) for d in shape_s.split(",")) if shape_s else ()
    return dtype, shape


def _int64_rec(v: int) -> bytes:
    """One single-value DSS int64 record — byte-identical to
    ``DssBuffer().pack_int64(v).tobytes()`` (native/dss.cc put_header:
    1-byte type tag DSS_INT64, u32 LE count, LE values) without a
    native buffer allocation per call. The live per-send header fields
    (transfer id, CRC) compose through this."""
    return b"\x01\x01\x00\x00\x00" + \
        int(v).to_bytes(8, "little", signed=True)


class FrameTemplate:
    """Precomposed SGH2/SGC2 framing for ONE fixed ``(shape, dtype,
    segsize)`` transfer slot, cached across transfers and frozen into
    the spanning schedule plans (``coll/plan.py``).

    Everything a header needs that does not depend on the send
    instant is packed ONCE here: the magic/dtype/shape/chunk-count
    records as raw DSS byte strings (DSS records are self-delimiting,
    so concatenated record strings unpack exactly like one
    sequentially-packed buffer) and the per-fragment slice offsets.
    A steady-state send then composes ``pre + xfer + mid + crc`` from
    four byte strings and slices the source memoryview at the stored
    offsets — no per-message dtype/shape stringification, no repeated
    DSS packing, no cvar reads. The transfer id and payload CRC are
    genuinely per-send (receiver resync and end-to-end integrity) and
    stay live."""

    __slots__ = ("shape", "dtype", "nbytes", "nchunks", "chunk",
                 "offsets", "pre", "mid", "idx_tails")

    def __init__(self, shape, dtype, segsize: int) -> None:
        from ..native import DssBuffer

        self.shape = tuple(int(d) for d in shape)
        self.dtype = str(dtype)
        size = int(np.prod(self.shape, dtype=np.int64)) if self.shape \
            else 1
        self.nbytes = size * storage_dtype(self.dtype).itemsize
        self.chunk = max(1, int(segsize))
        self.nchunks = max(1, -(-self.nbytes // self.chunk))
        self.offsets = tuple(i * self.chunk for i in range(self.nchunks))
        self.pre = DssBuffer().pack_string(_HDR2_MAGIC).tobytes()
        mid = DssBuffer()
        _pack_dtype_shape(mid, self.dtype, self.shape)
        mid.pack_int64([self.nchunks, self.chunk])
        self.mid = mid.tobytes()
        self.idx_tails = tuple(int(i).to_bytes(8, "big")
                               for i in range(self.nchunks))

    def matches(self, arr: np.ndarray, dtype_name: str) -> bool:
        return arr.shape == self.shape and dtype_name == self.dtype

    def header(self, xfer: int, crc: int) -> bytes:
        return b"".join((self.pre, _int64_rec(xfer),
                         self.mid, _int64_rec(crc)))

    def sg_lists(self, mv, xfer: int, crc: int):
        """Yield each wire frame of one transfer as a scatter-gather
        PART LIST instead of joined bytes: the header frame, then
        ``[magic+xfer, idx_tail, source_slice]`` per fragment. The
        nativewire datapath hands these lists to ``writev``/the shm
        ring, so the fragment payload goes from the source buffer to
        the wire without ever being joined into a Python bytes —
        ``b"".join``-ing each list reproduces the staged frames
        byte-identically (the identity the tests pin)."""
        yield [self.header(xfer, crc)]
        xb = _CHUNK2_MAGIC + int(xfer).to_bytes(8, "big")
        chunk = self.chunk
        for off, tail in zip(self.offsets, self.idx_tails):
            yield [xb, tail, mv[off:off + chunk]]


def plan_frame_template(shape, dtype, segsize: int) -> FrameTemplate:
    """Build the frozen framing for one planned transfer slot (see
    :class:`FrameTemplate`)."""
    return FrameTemplate(shape, dtype, segsize)

#: interpreted-path template cache: ``staged_frames`` used to re-pack
#: the constant header records (magic, dtype, shape, chunking) through
#: a fresh native DssBuffer on EVERY transfer; steady-state transfers
#: repeat a handful of (shape, dtype, segsize) slots, so the frozen
#: template is cached and only the per-send fields (xfer id, CRC) are
#: composed live. Bounded: an adversarial shape churn clears it rather
#: than growing without limit.
_TEMPLATE_CACHE: dict = {}
_TEMPLATE_CACHE_MAX = 512
_template_lock = threading.Lock()


def _template_for(shape, dtype, segsize: int) -> FrameTemplate:
    key = (tuple(shape), str(dtype), int(segsize))
    with _template_lock:
        tpl = _TEMPLATE_CACHE.get(key)
        if tpl is None:
            if len(_TEMPLATE_CACHE) >= _TEMPLATE_CACHE_MAX:
                _TEMPLATE_CACHE.clear()
            tpl = _TEMPLATE_CACHE[key] = FrameTemplate(
                shape, dtype, segsize)
        return tpl


_stash_guard = threading.Lock()


def _ep_stash(oob_ep):
    """The endpoint's frame stash + its lock, created once. Multiple
    threads poll stashed_recv on one endpoint concurrently (the window
    service, the nbc worker's coll_recv, the pml drain): iteration and
    setdefault on the dict must not race."""
    with _stash_guard:
        stash = getattr(oob_ep, "_dcn_stash", None)
        if stash is None:
            stash = oob_ep._dcn_stash = {}
            oob_ep._dcn_stash_lock = threading.Lock()
        return stash, oob_ep._dcn_stash_lock


def stashed_recv(oob_ep, want_src, tag: int, deadline: float):
    """Next (src, payload) for ``tag``, matched by source: frames from
    other senders interleaved on the same tag are stashed on the
    endpoint (the OOB recv filters by tag only) and served to their own
    consumer later — two concurrent transfers on one tag must not
    corrupt each other. ``want_src=None`` takes the oldest stashed
    frame from any source, else the next live frame from ``want_src``.

    Shared by every consumer that multiplexes one OOB endpoint and tag
    across multiple senders (the staged DCN path and the shm handoff).
    """
    import time as _time

    stash, lock = _ep_stash(oob_ep)
    with lock:
        if want_src is None:
            for (s, t), q in stash.items():
                if t == tag and q:
                    return s, q.pop(0)
        else:
            q = stash.get((want_src, tag))
            if q:
                return want_src, q.pop(0)
    while True:
        left = max(1, int((deadline - _time.monotonic()) * 1000))
        src, _, raw = oob_ep.recv(tag=tag, timeout_ms=left)
        if want_src is None or src == want_src:
            return src, raw
        with lock:
            stash.setdefault((src, tag), []).append(raw)


class SelfBtl(base.BtlModule):
    """Loopback: src == dst. Arrays are immutable; a self-send needs no
    copy at all (the reference's btl/self memcpys because its buffers
    are mutable — ours provably cannot alias a future write)."""

    NAME = "self"
    EAGER_LIMIT = 1 << 62
    MAX_SEND_SIZE = 1 << 62
    LATENCY = 0
    BANDWIDTH = 10 ** 9
    EXCLUSIVITY = 64 * 1024  # btl/self owns loopback outright

    def reachable(self, src_ep, dst_ep) -> bool:
        return src_ep.rank == dst_ep.rank

    def move_segment(self, data, dst_device):
        if getattr(data, "device", None) == torch.device(dst_device):
            return data
        return data.to(dst_device)


class IciBtl(base.BtlModule):
    """The in-card pair: a device copy inside this process.

    Virtual ranks share one H100, so a move between two of them is a
    copy on the card (``.to`` returns the tensor itself when it is
    already there; the PML copies before it hands a buffer over); two
    cards of one process copy peer to peer. No host bounce. On the CPU
    the same call is a host copy, so the tests exercise the decision
    logic without a card.
    """

    NAME = "ici"
    EAGER_LIMIT = 1 * 1024 * 1024
    MAX_SEND_SIZE = 64 * 1024 * 1024
    LATENCY = 1
    BANDWIDTH = 45_000  # ~45 GB/s/link ICI-scale ranking input
    EXCLUSIVITY = 1024

    def reachable(self, src_ep, dst_ep) -> bool:
        # same controller process only: a peer PROCESS's tensors are
        # not addressable here even on the same card — those pairs
        # belong to shm/dcn
        return (
            src_ep.rank != dst_ep.rank
            and src_ep.platform == dst_ep.platform
            and src_ep.slice_index == dst_ep.slice_index
            and src_ep.process_index == dst_ep.process_index
        )

    def move_segment(self, data, dst_device):
        return data.to(dst_device)


class DcnBtl(base.BtlModule):
    """Inter-slice / inter-host transfers over the data-center network.

    TWO genuinely distinct paths, selected by a capability check:

    * **intra-controller** (the destination device is addressable by
      this process): a device copy. This is the only case where a
      direct device move is even expressible.
    * **cross-process** (multi-controller: the peer's devices are NOT
      addressable here — a device copy would be a silent lie):
      :meth:`send_staged`/:meth:`recv_staged` — a chunked host-staged
      transfer over the native OOB (the btl/tcp role played
      honestly), with its own chunk/byte accounting, segmented at
      ``max_send_size`` exactly like the reference's pipelined
      protocol (``btl.h:802``). ``move_segment`` on an unaddressable
      device raises ERR_UNREACH loudly instead of claiming the route.
    """

    NAME = "dcn"
    EAGER_LIMIT = 64 * 1024          # tcp eager (btl_tcp_component.c:268)
    MAX_SEND_SIZE = 4 * 1024 * 1024
    LATENCY = 25
    BANDWIDTH = 12_500               # 100 Gb/s-class NIC
    EXCLUSIVITY = 512

    def reachable(self, src_ep, dst_ep) -> bool:
        return src_ep.rank != dst_ep.rank and (
            src_ep.slice_index != dst_ep.slice_index
            or src_ep.process_index != dst_ep.process_index
        )

    @property
    def staged_chunks_pvar(self):
        return self._cached_counter(
            "_staged_chunks_pvar", "btl_dcn_staged_chunks",
            "OOB-staged DCN chunks transferred")

    @property
    def staged_bytes_pvar(self):
        return self._cached_counter(
            "_staged_bytes_pvar", "btl_dcn_staged_bytes",
            "OOB-staged DCN bytes transferred")

    def move_segment(self, data, dst_device):
        # the actual multi-controller condition: a peer process's
        # device is never a torch device of this process
        if not isinstance(dst_device, (torch.device, str)):
            raise MPIError(
                ErrorCode.ERR_UNREACH,
                f"device {dst_device} belongs to another process; a "
                "multi-controller DCN transfer must go through "
                "DcnBtl.send_staged/recv_staged over the OOB "
                "(a device copy across controllers is not a real "
                "route)",
            )
        return data.to(dst_device)

    # -- cross-process staged path (the honest multi-controller route) ----
    _recv_from = staticmethod(stashed_recv)  # kept as the historical name

    #: (generation, value) stamp for the resolved segsize — the cvar
    #: used to be re-read through the registry lock on EVERY staged
    #: send; now a stale write-generation is the only thing that
    #: triggers a re-resolve (one attr read + int compare per send)
    _segsize_cache = (-1, 0)

    def pipeline_segsize(self) -> int:
        """Effective pipelined-fragment size: the ``wire_pipeline_segsize``
        cvar clamped to this btl's max frame size; 0 = the legacy
        monolithic ``tobytes()`` framing (exact pre-pipeline path).
        Resolved once per registry write generation, not per message."""
        gen, val = self._segsize_cache
        now = mca_var.VARS.generation
        if gen == now:
            return val
        # gen captured BEFORE the value read: a concurrent cvar write
        # that lands between the two bumps the generation past `now`,
        # so the possibly-stale value cached here can never be served
        # once the writer is done (stamping the generation read AFTER
        # would mask that write until an unrelated one)
        seg = int(mca_var.get("wire_pipeline_segsize", 0) or 0)
        if seg <= 0:
            seg = 0
        else:
            seg = min(seg, max(1, self.max_send_size))
        self._segsize_cache = (now, seg)
        return seg

    def staged_frames(self, data, *, segsize: int):
        """Yield the wire frames of ONE pipelined staged transfer:
        header first, then idx-stamped fragments whose payloads are
        memoryview slices over the source buffer (no whole-array
        ``tobytes()`` materialization). The caller owns the actual
        ``oob_ep.send`` calls, so frames from several transfers bound
        for DIFFERENT peers can be striped round-robin (the sliding
        in-flight window the wire router's ``coll_send_all`` drives).

        Sender-side pvar accounting lives HERE — the single place that
        knows frames — so ``send_staged`` and the router's striping
        path can never drift: chunks count as they are yielded, bytes
        count once when the stream completes."""
        import zlib

        arr, dname = host_payload(data)
        mv = memoryview(arr.reshape(-1).view(np.uint8)) if arr.size \
            else memoryview(b"")
        # constant header records come from the cached template; only
        # the xfer id and the CRC are composed per send
        tpl = _template_for(arr.shape, dname, segsize)
        xfer = next(_xfer_ids)
        # end-to-end payload CRC (the opal_datatype_checksum role):
        # one read pass over the source view, no copy
        yield tpl.header(xfer, zlib.crc32(mv))
        xb = _CHUNK2_MAGIC + int(xfer).to_bytes(8, "big")
        chunk = tpl.chunk
        for off, tail in zip(tpl.offsets, tpl.idx_tails):
            sl = mv[off:off + chunk]
            _sliced_bytes.add(len(sl))
            yield b"".join((xb, tail, sl))
            self.staged_chunks_pvar.add()
        self.staged_bytes_pvar.add(tpl.nbytes)

    def planned_frames(self, data, tpl: FrameTemplate):
        """Yield the wire frames of one staged transfer from a frozen
        :class:`FrameTemplate` — the steady-state send path of a
        compiled schedule plan: precomposed header byte strings plus
        memoryview slices at plan-time offsets. Byte-identical to
        :meth:`staged_frames` for the same array, with the same pvar
        accounting; only the per-send transfer id and payload CRC are
        computed live. A shape/dtype mismatch is a loud plan-integrity
        error, never a silently wrong header."""
        import zlib

        arr, dname = host_payload(data)
        if not tpl.matches(arr, dname):
            raise MPIError(
                ErrorCode.ERR_INTERN,
                f"planned staged transfer: buffer {arr.shape}/"
                f"{dname} does not match the frozen frame template "
                f"{tpl.shape}/{tpl.dtype} — schedule diverged from its "
                "plan (rebuild the persistent request)",
            )
        mv = memoryview(arr.reshape(-1).view(np.uint8)) if arr.size \
            else memoryview(b"")
        xfer = next(_xfer_ids)
        yield tpl.header(xfer, zlib.crc32(mv))
        xb = _CHUNK2_MAGIC + int(xfer).to_bytes(8, "big")
        chunk = tpl.chunk
        for off, tail in zip(tpl.offsets, tpl.idx_tails):
            sl = mv[off:off + chunk]
            _sliced_bytes.add(len(sl))
            yield b"".join((xb, tail, sl))
            self.staged_chunks_pvar.add()
        self.staged_bytes_pvar.add(tpl.nbytes)

    def send_staged(self, oob_ep, peer_nid: int, tag: int, data) -> int:
        """Stream ``data`` to ``peer_nid`` over the OOB in chunks.
        Returns the number of chunks sent. Every frame carries a
        transfer id so a receiver that abandoned an earlier transfer
        resynchronizes instead of parsing orphan chunks as headers.

        With ``wire_pipeline_segsize`` > 0 the transfer is pipelined:
        segsize-bounded fragments sliced straight off the source
        buffer (:meth:`staged_frames`); with 0 the exact legacy
        monolithic path runs (whole-array ``tobytes()``, max_send_size
        chunks, ordered join on receive)."""
        from ..native import DssBuffer

        _check_user_tag(tag)
        rec = _obs.enabled  # capture once: flag may flip mid-send
        t0 = _time.perf_counter() if rec else 0.0
        seg = self.pipeline_segsize()
        if seg > 0:
            nframes = 0
            for frame in self.staged_frames(data, segsize=seg):
                oob_ep.send(peer_nid, tag, frame)
                nframes += 1
            if rec and _obs.enabled:
                _obs.record("btl_staged_send", "btl", t0,
                            _time.perf_counter() - t0,
                            nbytes=payload_nbytes(data),
                            peer=peer_nid - 1)
            return nframes - 1  # header is not a chunk
        xfer = next(_xfer_ids)
        arr, dname = host_payload(data)
        raw = arr.tobytes()
        chunk = max(1, self.max_send_size)
        nchunks = max(1, -(-len(raw) // chunk))
        hdr = DssBuffer()
        hdr.pack_string(_HDR_MAGIC)
        hdr.pack_int64(xfer)
        _pack_array_header(hdr, arr, dname)
        hdr.pack_int64(nchunks)
        # end-to-end payload CRC (the opal_datatype_checksum role for
        # the cross-process wire): the receiver verifies the
        # reassembled bytes, catching corruption anywhere between the
        # sender's buffer and reassembly
        import zlib

        hdr.pack_int64(zlib.crc32(raw))
        oob_ep.send(peer_nid, tag, hdr.tobytes())
        xb = _CHUNK_MAGIC + int(xfer).to_bytes(8, "big")
        for i in range(nchunks):
            oob_ep.send(peer_nid, tag,
                        xb + raw[i * chunk:(i + 1) * chunk])
            self.staged_chunks_pvar.add()
        self.staged_bytes_pvar.add(len(raw))
        if rec and _obs.enabled:
            _obs.record("btl_staged_send", "btl", t0,
                        _time.perf_counter() - t0,
                        nbytes=len(raw), peer=peer_nid - 1)
        return nchunks

    def recv_staged(self, oob_ep, tag: int, *, src=None,
                    dst_device=None, timeout_ms: int = 30_000,
                    first=None):
        """Reassemble one staged transfer; returns a tensor on
        ``dst_device`` (default: a host tensor). All
        chunk frames are matched to the header's source, so transfers
        from different peers on one tag cannot interleave. The
        receiver accepts BOTH framings regardless of its local cvar:
        legacy ordered chunks are joined; pipelined idx-stamped
        fragments land in a preallocated buffer at their own offsets
        and the result is a ``np.frombuffer`` view over it (no join
        copy). ``first`` is an already-popped ``(src_nid, frame)``
        pair to resume from — the wire router's any-source reaping
        peeks the first frame to pick the readiest peer."""
        from ..native import DssBuffer

        _check_user_tag(tag)
        rec = _obs.enabled  # capture once: flag may flip mid-recv
        t_obs = _time.perf_counter() if rec else 0.0
        deadline = _time.monotonic() + timeout_ms / 1000
        # resync: discard frames until a valid header (orphan chunks
        # from an abandoned transfer must not be parsed as headers)
        while True:
            if first is not None:
                src_got, hraw = first
                first = None
            else:
                src_got, hraw = self._recv_from(oob_ep, src, tag,
                                                deadline)
            try:
                hdr = DssBuffer(hraw)
                magic = hdr.unpack_string()
                if magic not in (_HDR_MAGIC, _HDR2_MAGIC):
                    continue
                (xfer,) = hdr.unpack_int64()
                dtype, shape = _unpack_array_header(hdr)
                if magic == _HDR2_MAGIC:
                    nchunks, chunk = hdr.unpack_int64(2)
                else:
                    (nchunks,) = hdr.unpack_int64()
                    chunk = 0
                (crc,) = hdr.unpack_int64()
            except MPIError:
                continue  # a chunk frame: skip to the next header
            src = src_got
            break
        import zlib

        dname, dtype = dtype, storage_dtype(dtype)
        if magic == _HDR2_MAGIC:
            nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            if nbytes < 0 or any(d < 0 for d in shape):
                raise MPIError(ErrorCode.ERR_TRUNCATE,
                               f"staged transfer {xfer}: malformed "
                               f"shape {shape}")
            buf = bytearray(nbytes)
            bmv = memoryview(buf)
            want = _CHUNK2_MAGIC + int(xfer).to_bytes(8, "big")
            _frags_inflight.set(int(nchunks))
            got = 0
            while got < int(nchunks):
                _, praw = self._recv_from(oob_ep, src, tag, deadline)
                if not praw.startswith(want):
                    continue  # stale frame from an abandoned transfer
                idx = int.from_bytes(praw[12:20], "big")
                payload = memoryview(praw)[20:]
                off = idx * int(chunk)
                if idx >= int(nchunks) or off + len(payload) > nbytes:
                    raise MPIError(
                        ErrorCode.ERR_TRUNCATE,
                        f"staged transfer {xfer}: fragment {idx} "
                        f"overruns the {nbytes}-byte buffer",
                    )
                bmv[off:off + len(payload)] = payload
                got += 1
                self.staged_chunks_pvar.add()
            if zlib.crc32(bmv) != int(crc):
                raise MPIError(
                    ErrorCode.ERR_TRUNCATE,
                    f"staged transfer {xfer} failed its payload CRC — "
                    "wire corruption or interleaved frames",
                )
            _sliced_bytes.add(nbytes)
            arr = np.frombuffer(buf, dtype=dtype).reshape(shape)
        else:
            want = _CHUNK_MAGIC + int(xfer).to_bytes(8, "big")
            parts = []
            while len(parts) < int(nchunks):
                _, praw = self._recv_from(oob_ep, src, tag, deadline)
                if not praw.startswith(want):
                    continue  # stale chunk from an abandoned transfer
                parts.append(praw[len(want):])
                self.staged_chunks_pvar.add()
            raw = b"".join(parts)
            if zlib.crc32(raw) != int(crc):
                raise MPIError(
                    ErrorCode.ERR_TRUNCATE,
                    f"staged transfer {xfer} failed its payload CRC — "
                    "wire corruption or interleaved frames",
                )
            arr = np.frombuffer(bytearray(raw), dtype=dtype).reshape(shape)
        self.staged_bytes_pvar.add(arr.nbytes)
        if rec and _obs.enabled:
            _obs.record("btl_staged_recv", "btl", t_obs,
                        _time.perf_counter() - t_obs,
                        nbytes=int(arr.nbytes),
                        peer=(src - 1) if src is not None else -1)
        return host_tensor(arr, dname, dst_device)


class ShmBtl(base.BtlModule):
    """Intra-host CROSS-PROCESS device-buffer handoff through POSIX
    shared memory — the btl/vader role (SURVEY §2.4 item 9). The
    payload crosses the process boundary through one mmap'd segment
    (no socket streaming, no per-chunk copies): the sender writes
    device bytes straight into a named segment (one write, no
    intermediate buffer) and posts a control frame (name, dtype,
    shape) over the OOB — the vader "fast box". The receiver maps the
    segment, copies out (a tensor over the mapping would outlive the
    unlink), moves the copy to its device, and unlinks — ownership
    transfers with the frame.

    Instance registration for the reaper takes ``_reaper_lock``, and so
    does the finalizer of a collected instance. The lock is re-entrant:
    a garbage collection that runs a finalizer inside registration (on
    the registering thread, with the lock held) re-enters it instead of
    deadlocking.
    """

    NAME = "shm"
    EAGER_LIMIT = 32 * 1024
    MAX_SEND_SIZE = 256 * 1024 * 1024
    SUPPORTS_MOVE = False  # out-of-band: send_shm/recv_shm, never the
    #                        BML move lists (which hold movers only) —
    #                        so the latency/bandwidth/exclusivity
    #                        ranking attributes are deliberately left
    #                        at base defaults: selection happens via
    #                        reachable() alone, not move-list ranking

    def reachable(self, src_ep, dst_ep) -> bool:
        # same machine, different controller process: the only pair
        # shape where shm is both possible and needed (same process
        # uses ici/self; cross-host cannot map the segment)
        return (
            src_ep.process_index != dst_ep.process_index
            and bool(getattr(src_ep, "host", ""))
            and getattr(src_ep, "host", "") == getattr(dst_ep, "host", "")
        )

    def move_segment(self, data, dst_device):
        from ..utils.errors import ErrorCode, MPIError

        raise MPIError(
            ErrorCode.ERR_UNREACH,
            "shm is a cross-process transport: use "
            "send_shm/recv_shm with the peer's OOB endpoint",
        )

    @property
    def handoffs_pvar(self):
        return self._cached_counter(
            "_handoffs_pvar", "btl_shm_handoffs",
            "shared-memory segment handoffs")

    @property
    def shm_bytes_pvar(self):
        return self._cached_counter(
            "_shm_bytes_pvar", "btl_shm_bytes",
            "bytes handed off through shm")

    #: default TTL for posted-but-unconsumed segments; per-instance
    #: (set ``module.SEGMENT_TTL_S`` to tune one module without
    #: affecting other jobs' modules in the same process). Generous
    #: (4x the recv default) so a slow-but-live receiver is never
    #: pulled out from under.
    SEGMENT_TTL_S = 120.0

    #: module-level reaper thread: wakes periodically and reaps every
    #: live ShmBtl instance's expired segments, so a sender that STOPS
    #: sending no longer leaks /dev/shm until process exit (reaping
    #: used to happen only on the next send). Instances register in a
    #: weak set — pending segments are per-instance state, so two jobs'
    #: modules in one process never reap each other's segments early.
    _reaper_lock = threading.RLock()
    _reaper_thread = None
    _instances = None  # weakref.WeakSet, created with the reaper

    def __init__(self) -> None:
        import weakref

        #: segments posted but (maybe) never consumed: (name, deadline).
        #: A receiver that times out or dies never learns the name, so
        #: expired segments are reaped (on the next send and by the
        #: timer thread) — without this a retry loop leaks /dev/shm
        #: until the host runs out.
        self._pending_segments: list = []
        self._pending_lock = threading.Lock()
        ShmBtl._register_for_reaping(self)
        # a GC'd module must not take its pending records to the grave
        # (per-comm modules die with their communicator; a one-shot
        # `ShmBtl().send_shm(...)` dies immediately): at collection the
        # records move — deadlines intact — to a class-level orphan
        # list the timer thread keeps reaping. NOT unlinked eagerly:
        # ownership already passed to the receiver, who may be about
        # to map the segment; the TTL grace still applies.
        weakref.finalize(
            self, ShmBtl._adopt_orphans,
            self._pending_segments, self._pending_lock,
        )

    #: (name, deadline) records inherited from GC'd modules; reaped by
    #: the timer thread on the normal TTL schedule
    _orphaned: list = []

    @classmethod
    def _adopt_orphans(cls, pending: list, lock) -> None:
        with lock:
            records = list(pending)
            pending.clear()
        with cls._reaper_lock:
            cls._orphaned.extend(records)

    @classmethod
    def _reap_orphan_list(cls) -> None:
        import time as _time

        from multiprocessing import shared_memory

        now = _time.monotonic()
        with cls._reaper_lock:
            expired = [nd for nd in cls._orphaned if now >= nd[1]]
            cls._orphaned[:] = [nd for nd in cls._orphaned if now < nd[1]]
        for name, _deadline in expired:
            try:
                seg = shared_memory.SharedMemory(name=name)
                seg.close()
                seg.unlink()
            except FileNotFoundError:
                pass

    @classmethod
    def _register_for_reaping(cls, instance) -> None:
        import weakref

        with cls._reaper_lock:
            if cls._instances is None:
                cls._instances = weakref.WeakSet()
            cls._instances.add(instance)
            if cls._reaper_thread is None:
                t = threading.Thread(
                    target=cls._reaper_loop, daemon=True,
                    name="shm-segment-reaper",
                )
                cls._reaper_thread = t
                t.start()

    @classmethod
    def _reaper_loop(cls) -> None:
        import time as _time

        while True:
            _time.sleep(5.0)
            with cls._reaper_lock:
                live = list(cls._instances) if cls._instances else []
            for mod in live:
                try:
                    mod._reap_orphaned_segments()
                except Exception:
                    pass  # a reap failure must never kill the timer
            try:
                cls._reap_orphan_list()
            except Exception:
                pass

    def _reap_orphaned_segments(self) -> None:
        import time as _time

        from multiprocessing import shared_memory

        now = _time.monotonic()
        with self._pending_lock:  # concurrent senders append in here
            expired = [nd for nd in self._pending_segments
                       if now >= nd[1]]
            self._pending_segments[:] = [
                nd for nd in self._pending_segments if now < nd[1]
            ]
        for name, _deadline in expired:
            try:  # consumed segments are already unlinked: ignore
                seg = shared_memory.SharedMemory(name=name)
                seg.close()
                seg.unlink()
            except FileNotFoundError:
                pass

    def send_shm(self, oob_ep, peer_nid: int, tag: int, data) -> str:
        """Write ``data`` into a fresh shm segment and post the
        control frame; returns the segment name. Ownership of the
        segment passes to the receiver (it unlinks); segments whose
        receiver never consumed the frame are reaped after
        SEGMENT_TTL_S on a later send."""
        from multiprocessing import shared_memory

        from ..native import DssBuffer

        _check_user_tag(tag)
        rec = _obs.enabled  # capture once: flag may flip mid-handoff
        t_obs = _time.perf_counter() if rec else 0.0
        self._reap_orphaned_segments()
        arr, dname = host_payload(data)
        # name carries the creator pid so tpu-clean can reap segments
        # whose owner died without unlinking (orte-clean's leftover-
        # session duty); uuid tail avoids same-pid collisions
        seg = shared_memory.SharedMemory(
            create=True, size=max(1, arr.nbytes),
            name=f"ompitpu-{os.getpid()}-{uuid.uuid4().hex[:12]}",
        )
        try:
            # single copy: write straight into the mapping (tobytes()
            # would materialize a second full-size host buffer)
            if arr.size:
                np.frombuffer(seg.buf, dtype=arr.dtype,
                              count=arr.size)[:] = arr.ravel()
            frame = DssBuffer()
            frame.pack_string(seg.name)
            _pack_array_header(frame, arr, dname)
            oob_ep.send(peer_nid, tag, frame.tobytes())
        except BaseException:
            seg.close()
            seg.unlink()
            raise
        self.handoffs_pvar.add()
        self.shm_bytes_pvar.add(arr.nbytes)
        name = seg.name
        seg.close()  # receiver owns the segment now
        # ownership transferred: drop OUR resource_tracker registration
        # or the tracker warns at exit about every segment the receiver
        # unlinked (and would double-unlink ones it didn't). The
        # receiver's attach registers in ITS tracker; our TTL reap
        # re-attaches (re-registering) before unlinking — every path
        # stays tracker-consistent. Cost: a segment orphaned by our
        # death inside the TTL window outlives us in /dev/shm.
        try:
            from multiprocessing import resource_tracker

            resource_tracker.unregister(f"/{name}", "shared_memory")
        except Exception:
            pass  # tracker API is CPython-internal; never fail a send
        with self._pending_lock:
            self._pending_segments.append(
                (name, _time.monotonic() + self.SEGMENT_TTL_S)
            )
        if rec and _obs.enabled:
            _obs.record("btl_shm_send", "btl", t_obs,
                        _time.perf_counter() - t_obs,
                        nbytes=int(arr.nbytes), peer=peer_nid - 1)
        return name

    def recv_shm(self, oob_ep, tag: int, *, src=None, dst_device=None,
                 timeout_ms: int = 30_000, first=None):
        """Map the announced segment, copy out of it, unlink; returns a
        tensor on ``dst_device`` (default: a host tensor). ``src`` filters control frames by sender node id
        (frames from other senders on the same tag are stashed for
        their own consumer — same discipline as the staged path).
        ``first`` is an already-popped ``(src_nid, frame)`` pair to
        resume from (the wire router's any-source reaping)."""
        from multiprocessing import shared_memory

        from ..native import DssBuffer

        _check_user_tag(tag)
        rec = _obs.enabled  # capture once: flag may flip mid-handoff
        t_obs = _time.perf_counter() if rec else 0.0
        deadline = _time.monotonic() + timeout_ms / 1000
        if first is not None:
            _, raw = first
        else:
            _, raw = stashed_recv(oob_ep, src, tag, deadline)
        frame = DssBuffer(raw)
        name = frame.unpack_string()
        dname, shape = _unpack_array_header(frame)
        dtype = storage_dtype(dname)
        try:
            seg = shared_memory.SharedMemory(name=name)
        except FileNotFoundError:
            from ..utils.errors import ErrorCode as _EC, MPIError as _ME

            raise _ME(
                _EC.ERR_OTHER,
                f"shm segment '{name}' no longer exists (reaped after "
                f"TTL or sender died) — the handoff frame is stale",
            )
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if any(d < 0 for d in shape) or nbytes < 0 or nbytes > seg.size:
            # malformed/hostile control frame: do NOT unlink — the
            # segment stays for the sender's TTL reaper, and the error
            # is an MPI truncation, not a raw numpy ValueError
            seg.close()
            raise MPIError(
                ErrorCode.ERR_TRUNCATE,
                f"shm control frame claims {nbytes} bytes but segment "
                f"'{name}' holds only {seg.size} — frame rejected, "
                "segment left for the sender's TTL reaper",
            )
        try:
            view = np.frombuffer(seg.buf[:nbytes],
                                 dtype=dtype).reshape(shape)
            # copy OUT of the mapping before unmapping: a tensor built
            # over the mapped pages would outlive the unlink (a
            # use-after-free). The receive is therefore segment ->
            # host array -> device: one host memcpy more than the
            # send side's single write, still no socket streaming
            staged = np.array(view)
            del view
            out = host_tensor(staged, dname, dst_device)
        finally:
            seg.close()
            seg.unlink()
        self.handoffs_pvar.add()
        self.shm_bytes_pvar.add(nbytes)
        if rec and _obs.enabled:
            _obs.record("btl_shm_recv", "btl", t_obs,
                        _time.perf_counter() - t_obs, nbytes=int(nbytes),
                        peer=(src - 1) if src is not None else -1)
        return out


class HostBtl(base.BtlModule):
    """Explicit host-staged bounce: device → host numpy → device.

    The universal fallback (reaches every pair), and the measurement
    path for "how much does host staging cost" — the anti-pattern the
    north star forbids on the hot path, kept selectable for debugging
    exactly like forcing ``--mca btl tcp,self`` onto a verbs cluster.
    """

    NAME = "host"
    EAGER_LIMIT = 4 * 1024           # sm eager (btl_sm_component.c:244)
    MAX_SEND_SIZE = 32 * 1024 * 1024
    LATENCY = 100
    BANDWIDTH = 5_000
    EXCLUSIVITY = 0

    def reachable(self, src_ep, dst_ep) -> bool:
        return True

    def move_segment(self, data, dst_device):
        staged = data.to("cpu")  # explicit device→host fetch
        return staged.to(dst_device)


class _BtlComponent(mca_component.Component):
    """Shared component shell: one module class each."""

    MODULE_CLS = None

    def register_vars(self) -> None:
        base.register_module_vars(self.MODULE_CLS)

    def query(self, ctx=None):
        return (self.priority, self.MODULE_CLS())


class SelfComponent(_BtlComponent):
    NAME = "self"
    PRIORITY = 80
    MODULE_CLS = SelfBtl


class IciComponent(_BtlComponent):
    NAME = "ici"
    PRIORITY = 60
    MODULE_CLS = IciBtl


class ShmComponent(_BtlComponent):
    NAME = "shm"
    PRIORITY = 50
    MODULE_CLS = ShmBtl


class DcnComponent(_BtlComponent):
    NAME = "dcn"
    PRIORITY = 40
    MODULE_CLS = DcnBtl


class HostComponent(_BtlComponent):
    NAME = "host"
    PRIORITY = 10
    MODULE_CLS = HostBtl


base.BTL_FRAMEWORK.register(SelfComponent())
base.BTL_FRAMEWORK.register(IciComponent())
base.BTL_FRAMEWORK.register(ShmComponent())
base.BTL_FRAMEWORK.register(DcnComponent())
base.BTL_FRAMEWORK.register(HostComponent())
