"""ctypes wrappers over the native DSS + OOB library.

Counterpart of ``ompi_release_tpu/native/bindings.py``: ``DssBuffer``
(the DSS serialization), ``OobEndpoint`` (the OOB/RML TCP control
plane), ``USER_TAG_BASE`` and the job-secret handshake. The C sources
are the JAX package's ``native/*.cc``; the port compiles them into its
own ignored ``ompi_release_tpu_torch/build/native/`` (see
:func:`build_library`) and never writes under ``native/``.

The ``wire_*``/``shmring_*``/``planexec_*`` datapath symbols stay
optional capabilities, as in the reference (a stale ``.so`` lacks
them and the callers withdraw): :func:`wire_symbols_available`,
:func:`telemetry_symbols_available` and
:func:`planexec_symbols_available` probe them; ``OobEndpoint.sendv``/
``recv_frag``/``wire_stats``, :class:`ShmRing` and :class:`PlanExec`
wrap them for ``btl/nativewire`` and ``coll/native_exec``;
:class:`NativeEventRing` wraps the native event ring the transports
append one record per fragment to (``obs/nativeev.py`` decodes it).
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import threading
from typing import List, Optional, Tuple, Union

from ..utils import output
from ..utils.errors import ErrorCode, MPIError

_log = output.stream("native")

#: OOB tag space: tags below this are reserved for the control plane
#: (coordinator wire-up 1-8, pubsub 9-12); user payload transports
#: (staged DCN, shm handoff, spawn messaging) must use tags >= this
USER_TAG_BASE = 100

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
#: the C sources: read, never written (the JAX package's tree)
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
#: the port's own build directory (ignored by git): ``make BUILD=...``
#: puts the library and its stamp here, so ``native/`` stays untouched
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "native")
_SO_NAME = "libompitpu_native.so"

_lib = None
_lib_lock = threading.Lock()

#: stamp inputs — must match the Makefile's STAMP_SRCS list (same
#: files; order is irrelevant, the comparison is by name)
_STAMP_INPUTS = ("dss.cc", "oob.cc", "btl_tcp.cc", "btl_shm.cc",
                 "nativeev.cc", "planexec.cc", "oob_endpoint.h",
                 "nativeev.h", "Makefile")


def _stamp_current(build_dir: str) -> bool:
    """True when ``build_dir``/.srcstamp matches the sha256 of every stamp
    input — i.e. the .so was linked from exactly these sources and
    `make` would be a no-op. Content hashes, not mtimes: fresh git
    checkouts and build caches produce equal/reordered mtimes where a
    newer-than check lies in both directions. A missing or short
    stamp (pre-stamp build tree) just means 'run make once'."""
    import hashlib

    try:
        with open(os.path.join(build_dir, ".srcstamp")) as f:
            stamped = {}
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    stamped[parts[-1]] = parts[0]
    except OSError:
        return False
    for name in _STAMP_INPUTS:
        path = os.path.join(_NATIVE_DIR, name)
        if not os.path.exists(path):
            continue  # optional source absent on both sides is fine
        try:
            with open(path, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
        except OSError:
            return False
        if stamped.get(name) != digest:
            return False
    return True


def build_library(build_dir: Optional[str] = None) -> Tuple[str, bool]:
    """Build the native library into ``build_dir`` (default: the
    port's ``build/native``) unless its stamp is current. Returns
    ``(path of the .so, whether make ran)``.

    ``make -C native BUILD=<abs dir>`` compiles the sources in place
    and writes only under ``build_dir``. An exclusive file lock around
    the check and the build keeps two processes of one job (or two
    test workers) from running two ``make``s into one directory; the
    second waits and then finds the stamp current."""
    import fcntl

    build_dir = os.path.abspath(build_dir or _BUILD_DIR)
    os.makedirs(build_dir, exist_ok=True)
    so_path = os.path.join(build_dir, _SO_NAME)
    with open(os.path.join(build_dir, ".lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if os.path.exists(so_path) and _stamp_current(build_dir):
                return so_path, False
            _log.verbose(1, f"building native library into {build_dir}")
            r = subprocess.run(
                ["make", "-C", _NATIVE_DIR, "-s", "all",
                 f"BUILD={build_dir}"],
                capture_output=True, text=True,
            )
            if r.returncode != 0:
                raise MPIError(
                    ErrorCode.ERR_OTHER,
                    f"native build failed:\n{r.stdout}\n{r.stderr}",
                )
            return so_path, True
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def load_library() -> ctypes.CDLL:
    """Load (building if needed) the native library from the port's
    build directory. An up-to-date .so skips the compiler entirely:
    the Makefile stamps each link with the sha256 of its inputs and
    :func:`_stamp_current` re-hashes them in-process."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so_path, _ = build_library()
        lib = ctypes.CDLL(so_path)
        _declare(lib)
        _lib = lib
        return lib


def _declare(lib: ctypes.CDLL) -> None:
    P = ctypes.c_void_p
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)

    lib.dss_new.restype = P
    lib.dss_free.argtypes = [P]
    lib.dss_data.argtypes = [P]
    lib.dss_data.restype = u8p
    lib.dss_size.argtypes = [P]
    lib.dss_size.restype = ctypes.c_int64
    lib.dss_rewind.argtypes = [P]
    lib.dss_from_bytes.argtypes = [u8p, ctypes.c_int64]
    lib.dss_from_bytes.restype = P
    lib.dss_pack_int64.argtypes = [P, i64p, ctypes.c_int32]
    lib.dss_pack_double.argtypes = [P, f64p, ctypes.c_int32]
    lib.dss_pack_string.argtypes = [P, ctypes.c_char_p]
    lib.dss_pack_bytes.argtypes = [P, u8p, ctypes.c_int32]
    lib.dss_peek.argtypes = [P, i32p, i32p]
    lib.dss_unpack_int64.argtypes = [P, i64p, ctypes.c_int32]
    lib.dss_unpack_double.argtypes = [P, f64p, ctypes.c_int32]
    lib.dss_unpack_string.argtypes = [P, ctypes.c_char_p, ctypes.c_int32]
    lib.dss_unpack_bytes.argtypes = [P, u8p, ctypes.c_int32]

    lib.oob_create.argtypes = [ctypes.c_int32, ctypes.c_int]
    lib.oob_create.restype = P
    lib.oob_create_bound.argtypes = [ctypes.c_int32, ctypes.c_int,
                                     ctypes.c_char_p]
    lib.oob_create_bound.restype = P
    lib.oob_port.argtypes = [P]
    lib.oob_port.restype = ctypes.c_int
    lib.oob_connect.argtypes = [P, ctypes.c_int32, ctypes.c_char_p,
                                ctypes.c_int]
    lib.oob_connect.restype = ctypes.c_int
    lib.oob_add_route.argtypes = [P, ctypes.c_int32, ctypes.c_int32]
    lib.oob_send.argtypes = [P, ctypes.c_int32, ctypes.c_int32, u8p,
                             ctypes.c_int32]
    lib.oob_send.restype = ctypes.c_int
    lib.oob_recv.argtypes = [P, i32p, i32p, u8p, ctypes.c_int32,
                             ctypes.c_int]
    lib.oob_recv.restype = ctypes.c_int
    lib.oob_pending.argtypes = [P]
    lib.oob_pending.restype = ctypes.c_int
    lib.oob_ttl_dropped.argtypes = [P]
    lib.oob_ttl_dropped.restype = ctypes.c_int
    lib.oob_create_auth.argtypes = [ctypes.c_int32, ctypes.c_int,
                                    ctypes.c_char_p, u8p,
                                    ctypes.c_int32]
    lib.oob_create_auth.restype = P
    lib.oob_auth_rejected.argtypes = [P]
    lib.oob_auth_rejected.restype = ctypes.c_int
    lib.oob_next_len.argtypes = [P, ctypes.c_int32, ctypes.c_int]
    lib.oob_next_len.restype = ctypes.c_int
    lib.oob_destroy.argtypes = [P]

    # nativewire datapath symbols are OPTIONAL: a stale .so built from
    # pre-nativewire sources simply lacks them — declaring them is
    # therefore guarded, never assumed
    vpp = ctypes.POINTER(ctypes.c_void_p)
    if hasattr(lib, "wire_sendv"):
        lib.wire_sendv.argtypes = [P, ctypes.c_int32, ctypes.c_int32,
                                   vpp, i64p, ctypes.c_int32]
        lib.wire_sendv.restype = ctypes.c_int
        lib.wire_recv_frag.argtypes = [
            P, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, P, ctypes.c_int64,
            ctypes.c_int,
        ]
        lib.wire_recv_frag.restype = ctypes.c_int64
    if hasattr(lib, "wire_stats"):
        lib.wire_stats.argtypes = [P, ctypes.c_int32]
        lib.wire_stats.restype = ctypes.c_int64
    if hasattr(lib, "shmring_create"):
        lib.shmring_create.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                       ctypes.c_int64]
        lib.shmring_create.restype = P
        lib.shmring_attach.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.shmring_attach.restype = P
        lib.shmring_unlink.argtypes = [ctypes.c_char_p]
        lib.shmring_unlink.restype = ctypes.c_int
        lib.shmring_close.argtypes = [P]
        for f in ("shmring_capacity", "shmring_producer_pid",
                  "shmring_consumer_pid", "shmring_pending"):
            getattr(lib, f).argtypes = [P]
            getattr(lib, f).restype = ctypes.c_int64
        lib.shmring_writev.argtypes = [P, ctypes.c_int32, vpp, i64p,
                                       ctypes.c_int32, ctypes.c_int]
        lib.shmring_writev.restype = ctypes.c_int
        lib.shmring_read_frag.argtypes = [
            P, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, P, ctypes.c_int64, ctypes.c_int,
        ]
        lib.shmring_read_frag.restype = ctypes.c_int64
        lib.shmring_read_into.argtypes = [P, i32p, P, ctypes.c_int64,
                                          ctypes.c_int]
        lib.shmring_read_into.restype = ctypes.c_int64
    if hasattr(lib, "shmring_stat"):
        lib.shmring_stat.argtypes = [P, ctypes.c_int32]
        lib.shmring_stat.restype = ctypes.c_int64
    if hasattr(lib, "nativeev_create"):
        lib.nativeev_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.nativeev_create.restype = P
        lib.nativeev_attach.argtypes = [ctypes.c_char_p]
        lib.nativeev_attach.restype = P
        lib.nativeev_unlink.argtypes = [ctypes.c_char_p]
        lib.nativeev_unlink.restype = ctypes.c_int
        lib.nativeev_close.argtypes = [P]
        lib.nativeev_install.argtypes = [P]
        lib.nativeev_nslots.argtypes = [P]
        lib.nativeev_nslots.restype = ctypes.c_int64
        lib.nativeev_count.argtypes = [P]
        lib.nativeev_count.restype = ctypes.c_int64
        lib.nativeev_read.argtypes = [P, ctypes.c_int64, P,
                                      ctypes.c_int64, i64p]
        lib.nativeev_read.restype = ctypes.c_int64
    if hasattr(lib, "planexec_create"):
        lib.planexec_create.argtypes = [u8p, ctypes.c_int64]
        lib.planexec_create.restype = P
        lib.planexec_destroy.argtypes = [P]
        lib.planexec_bind.argtypes = [P, P, ctypes.c_int64, i64p,
                                      vpp, vpp, ctypes.c_int64]
        lib.planexec_bind.restype = ctypes.c_int
        lib.planexec_set_ftword.argtypes = [P, i64p]
        lib.planexec_fire_begin.argtypes = [P, vpp, i64p,
                                            ctypes.c_int64,
                                            ctypes.c_int64,
                                            ctypes.c_int64]
        lib.planexec_fire_begin.restype = ctypes.c_int
        lib.planexec_fire_step.argtypes = [P, ctypes.c_int64]
        lib.planexec_fire_step.restype = ctypes.c_int
        lib.planexec_pool_ptr.argtypes = [P]
        lib.planexec_pool_ptr.restype = P
        lib.planexec_ts_ptr.argtypes = [P]
        lib.planexec_ts_ptr.restype = ctypes.POINTER(ctypes.c_double)
        for f in ("planexec_pool_total", "planexec_pool_count",
                  "planexec_round_count", "planexec_input_count",
                  "planexec_err_peer", "planexec_err_round",
                  "planexec_stash_count"):
            getattr(lib, f).argtypes = [P]
            getattr(lib, f).restype = ctypes.c_int64
        lib.planexec_stash_info.argtypes = [P, ctypes.c_int64, i64p,
                                            i64p, i64p]
        lib.planexec_stash_info.restype = ctypes.c_int64
        lib.planexec_stash_data.argtypes = [P, ctypes.c_int64]
        lib.planexec_stash_data.restype = P
        lib.planexec_stash_clear.argtypes = [P]


def wire_symbols_available() -> bool:
    """True when the loaded .so carries the nativewire datapath ABI
    (wire_sendv/shmring_*). False — never an exception — when the
    library is stale, unbuildable, or the build toolchain is absent:
    callers treat that as 'capability not present' and stay on the
    portable staged path."""
    try:
        lib = load_library()
    except Exception:
        return False
    return hasattr(lib, "wire_sendv") and hasattr(lib, "shmring_create")


def telemetry_symbols_available() -> bool:
    """True when the loaded .so carries the native telemetry ABI
    (shmring_stat / wire_stats / nativeev_*). Same never-raises
    discipline as :func:`wire_symbols_available`: a stale .so built
    before the telemetry block means 'capability absent', and the
    observability layers simply stay dark for the native plane."""
    try:
        lib = load_library()
    except Exception:
        return False
    return (hasattr(lib, "shmring_stat") and hasattr(lib, "wire_stats")
            and hasattr(lib, "nativeev_create"))


def planexec_symbols_available() -> bool:
    """True when the loaded .so carries the native plan-executor ABI
    (planexec_*). Same never-raises discipline as
    :func:`wire_symbols_available`: a stale .so means 'capability
    absent' and compiled plans keep firing through the interpreted
    PlannedXchg replay."""
    try:
        lib = load_library()
    except Exception:
        return False
    return (hasattr(lib, "planexec_create")
            and hasattr(lib, "wire_sendv")
            and hasattr(lib, "shmring_create"))


def _u8(data: bytes):
    return ctypes.cast(
        ctypes.create_string_buffer(data, len(data)),
        ctypes.POINTER(ctypes.c_uint8),
    )


def _sg_arrays(parts):
    """(void* array, int64 array, keepalive list) for a scatter-gather
    list of bytes/bytearray/memoryview/ndarray parts — pointers into
    the callers' existing buffers, NO staging copies (the whole point
    of the native wire). The keepalive list must stay referenced until
    the C call returns."""
    import numpy as _np

    n = len(parts)
    ptrs = (ctypes.c_void_p * n)()
    lens = (ctypes.c_int64 * n)()
    keep = []
    for i, p in enumerate(parts):
        if isinstance(p, bytes):
            # c_char_p aliases the bytes object's internal buffer
            ptrs[i] = ctypes.cast(ctypes.c_char_p(p),
                                  ctypes.c_void_p)
            lens[i] = len(p)
            keep.append(p)
        else:
            a = _np.frombuffer(p, dtype=_np.uint8)  # zero-copy view
            ptrs[i] = ctypes.c_void_p(a.ctypes.data)
            lens[i] = a.nbytes
            keep.append(a)
    return ptrs, lens, keep


def _wbuf_ptr(buf):
    """(void* base, nbytes, keepalive) for a WRITABLE reassembly
    buffer (bytearray / writable memoryview / ndarray)."""
    import numpy as _np

    a = _np.frombuffer(buf, dtype=_np.uint8)
    if not a.flags.writeable:
        raise MPIError(ErrorCode.ERR_OTHER,
                       "recv_into target buffer is read-only")
    return ctypes.c_void_p(a.ctypes.data), a.nbytes, a


class DssBuffer:
    """Typed pack/unpack buffer (opal/dss analogue)."""

    TYPES = {1: "int64", 2: "double", 3: "string", 4: "bytes"}

    def __init__(self, raw: Optional[bytes] = None) -> None:
        self._lib = load_library()
        if raw is None:
            self._h = self._lib.dss_new()
        else:
            self._h = self._lib.dss_from_bytes(_u8(raw), len(raw))

    def close(self) -> None:
        if self._h:
            self._lib.dss_free(self._h)
            self._h = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass

    # -- pack --------------------------------------------------------------
    def pack_int64(self, vals: Union[int, List[int]]) -> "DssBuffer":
        vals = [vals] if isinstance(vals, int) else list(vals)
        arr = (ctypes.c_int64 * len(vals))(*vals)
        self._lib.dss_pack_int64(self._h, arr, len(vals))
        return self

    def pack_double(self, vals: Union[float, List[float]]) -> "DssBuffer":
        vals = [vals] if isinstance(vals, float) else list(vals)
        arr = (ctypes.c_double * len(vals))(*vals)
        self._lib.dss_pack_double(self._h, arr, len(vals))
        return self

    def pack_string(self, s: str) -> "DssBuffer":
        self._lib.dss_pack_string(self._h, s.encode())
        return self

    def pack_bytes(self, b: bytes) -> "DssBuffer":
        self._lib.dss_pack_bytes(self._h, _u8(b), len(b))
        return self

    # -- unpack ------------------------------------------------------------
    def peek(self) -> Optional[Tuple[str, int]]:
        t = ctypes.c_int32()
        c = ctypes.c_int32()
        if self._lib.dss_peek(self._h, ctypes.byref(t),
                              ctypes.byref(c)) != 0:
            return None
        return self.TYPES.get(t.value, "?"), c.value

    def _check(self, n: int, what: str) -> int:
        if n == -2:
            raise MPIError(
                ErrorCode.ERR_TYPE,
                f"dss unpack type mismatch: next item is "
                f"{self.peek()}, wanted {what}",
            )
        if n < 0:
            raise MPIError(ErrorCode.ERR_TRUNCATE,
                           f"dss buffer exhausted unpacking {what}")
        return n

    def unpack_int64(self, max_count: int = 1_048_576) -> List[int]:
        arr = (ctypes.c_int64 * max_count)()
        n = self._check(
            self._lib.dss_unpack_int64(self._h, arr, max_count), "int64"
        )
        return list(arr[:n])

    def unpack_double(self, max_count: int = 1_048_576) -> List[float]:
        arr = (ctypes.c_double * max_count)()
        n = self._check(
            self._lib.dss_unpack_double(self._h, arr, max_count), "double"
        )
        return list(arr[:n])

    def unpack_string(self, max_len: int = 1 << 20) -> str:
        buf = ctypes.create_string_buffer(max_len)
        self._check(
            self._lib.dss_unpack_string(self._h, buf, max_len), "string"
        )
        return buf.value.decode()

    def unpack_bytes(self, max_len: int = 1 << 26) -> bytes:
        arr = (ctypes.c_uint8 * max_len)()
        n = self._check(
            self._lib.dss_unpack_bytes(self._h, arr, max_len), "bytes"
        )
        return bytes(arr[:n])

    # -- raw ---------------------------------------------------------------
    def tobytes(self) -> bytes:
        n = self._lib.dss_size(self._h)
        p = self._lib.dss_data(self._h)
        return ctypes.string_at(p, n)  # one memcpy, not a Python loop

    def rewind(self) -> None:
        self._lib.dss_rewind(self._h)


#: env var carrying the per-job control-plane secret (minted by tpurun,
#: inherited by every worker it launches) — see SECRET_ENV consumers in
#: tools/tpurun.py and tools/tpu_server.py
SECRET_ENV = "OMPITPU_JOB_SECRET"


class OobEndpoint:
    """Tagged TCP messaging endpoint with tree routing (oob/rml/routed
    analogue).

    Authentication (``opal/mca/sec`` analogue): when ``secret`` is
    given — or ``OMPITPU_JOB_SECRET`` is set, which tpurun exports to
    every worker — inbound connections must answer a fresh-nonce
    SipHash challenge before any of their frames are accepted, and
    outbound connects answer the peer's challenge. ``secret=b""``
    explicitly disables auth regardless of the environment."""

    def __init__(self, node_id: int, port: int = 0,
                 bind_addr: str = "127.0.0.1",
                 secret: Optional[bytes] = None) -> None:
        import os as _os

        self._lib = load_library()
        if secret is None:
            env = _os.environ.get(SECRET_ENV, "")
            secret = env.encode() if env else b""
        # the secret rides the CREATE call: installed before the
        # listener accepts its first connection, so there is no window
        # in which an unauthenticated connection can be admitted
        self._h = self._lib.oob_create_auth(
            node_id, port, bind_addr.encode(),
            _u8(secret) if secret else None, len(secret),
        )
        if not self._h:
            raise MPIError(ErrorCode.ERR_OTHER,
                           f"oob_create failed ({bind_addr}:{port})")
        self.node_id = node_id

    def auth_rejected(self) -> int:
        """Inbound connections refused by the auth challenge."""
        return self._lib.oob_auth_rejected(self._handle())

    def _handle(self):
        """The live native handle; a closed endpoint raises a clean
        MPIError instead of handing NULL to the C layer (which
        segfaults — observed via use-after-close in spawn teardown)."""
        h = self._h
        if not h:
            raise MPIError(ErrorCode.ERR_OTHER,
                           "oob endpoint is closed")
        return h

    @property
    def port(self) -> int:
        return self._lib.oob_port(self._handle())

    def connect(self, peer_id: int, host: str, port: int) -> None:
        if self._lib.oob_connect(self._handle(), peer_id, host.encode(),
                                 port) != 0:
            raise MPIError(
                ErrorCode.ERR_OTHER,
                f"oob connect to node {peer_id} at {host}:{port} failed",
            )

    def add_route(self, dst: int, via: int) -> None:
        self._lib.oob_add_route(self._handle(), dst, via)

    def set_default_route(self, via: int) -> None:
        self._lib.oob_add_route(self._handle(), -1, via)

    def send(self, dst: int, tag: int, payload: bytes) -> None:
        if self._lib.oob_send(self._handle(), dst, tag, _u8(payload),
                              len(payload)) != 0:
            raise MPIError(
                ErrorCode.ERR_OTHER,
                f"oob send to {dst} failed (no connection or route)",
            )

    def recv(self, tag: int = -1,
             timeout_ms: int = 10_000) -> Tuple[int, int, bytes]:
        """Returns (src, tag, payload); raises on timeout.

        The buffer is sized from the queued frame's actual length
        (oob_next_len) instead of a worst-case allocation. A concurrent
        consumer of the same tag can race the size query; the -2 retry
        loop below re-sizes and tries again. One deadline bounds the
        whole call — retries never extend it past timeout_ms.
        """
        import time as _time

        deadline = _time.monotonic() + timeout_ms / 1000
        while True:
            left = max(1, int((deadline - _time.monotonic()) * 1000))
            n = self._lib.oob_next_len(self._handle(), tag, left)
            if n < 0:
                raise MPIError(ErrorCode.ERR_PENDING,
                               f"oob recv timeout (tag {tag})")
            src = ctypes.c_int32()
            tg = ctypes.c_int32(tag)
            arr = (ctypes.c_uint8 * max(n, 1))()
            left = max(1, int((deadline - _time.monotonic()) * 1000))
            got = self._lib.oob_recv(self._handle(), ctypes.byref(src),
                                     ctypes.byref(tg), arr, n, left)
            if got == -2:
                continue  # raced with another consumer; re-size
            if got == -1:
                raise MPIError(ErrorCode.ERR_PENDING,
                               f"oob recv timeout (tag {tag})")
            return src.value, tg.value, ctypes.string_at(arr, got)

    # -- nativewire datapath (optional capability) ------------------------

    def sendv(self, dst: int, tag: int, parts) -> None:
        """Vectored send: one frame whose payload is the concatenation
        of `parts`, written with writev straight from the parts'
        buffers — no b"".join, no ctypes staging copy. Byte-identical
        on the wire to ``send(dst, tag, b"".join(parts))``."""
        ptrs, lens, keep = _sg_arrays(parts)
        rc = self._lib.wire_sendv(self._handle(), dst, tag, ptrs, lens,
                                  len(ptrs))
        del keep
        if rc != 0:
            raise MPIError(
                ErrorCode.ERR_OTHER,
                f"wire sendv to {dst} failed (no connection or route)",
            )

    def recv_frag(self, src: int, tag: int, xfer: int, nchunks: int,
                  chunk: int, buf, timeout_ms: int) -> int:
        """Pop the next SGC2 fragment of (src, tag, xfer) straight
        into writable `buf`. Returns the fragment index >= 0, or the
        C status: -1 timeout, -2 malformed (consumed), -4 the next
        matching frame belongs to the portable path (left queued)."""
        base, nbytes, keep = _wbuf_ptr(buf)
        rc = self._lib.wire_recv_frag(self._handle(), src, tag, xfer,
                                      nchunks, chunk, base, nbytes,
                                      timeout_ms)
        del keep
        return int(rc)

    def ttl_dropped(self) -> int:
        """Frames dropped by the routing-cycle ttl guard."""
        return self._lib.oob_ttl_dropped(self._handle())

    #: wire_stats index names, in C-side order (native/btl_tcp.cc)
    WIRE_STATS = ("tx_frames", "tx_bytes", "rx_frames", "rx_bytes",
                  "rx_stalls", "rx_stall_ns")

    def wire_stats(self) -> dict:
        """The endpoint's native-wire telemetry block as a dict; all
        zeros when the loaded .so predates the telemetry ABI."""
        if not hasattr(self._lib, "wire_stats"):
            return {k: 0 for k in self.WIRE_STATS}
        h = self._handle()
        return {k: int(self._lib.wire_stats(h, i))
                for i, k in enumerate(self.WIRE_STATS)}

    def pending(self) -> int:
        return self._lib.oob_pending(self._handle())

    def close(self) -> None:
        if self._h:
            self._lib.oob_destroy(self._h)
            self._h = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass


class ShmRing:
    """SPSC shared-memory byte ring (btl/sm FIFO analogue).

    Mechanical wrapper: status ints pass through unchanged; mapping
    -3 (peer process gone) onto the typed fault-tolerance error is the
    btl component's job, not the binding's. Ring protocol status codes
    (native/btl_shm.cc): writev 0/-1 timeout/-2 never-fits/-3 dead;
    read_frag idx/-1/-2 consumed-bad/-3 dead/-4 stale-dropped/-5
    other-tag-left; read_into len/-1/-2 too-small/-3 dead."""

    def __init__(self, handle, name: str) -> None:
        self._lib = load_library()
        self._h = handle
        self.name = name

    @classmethod
    def create(cls, name: str, capacity: int,
               producer_pid: int) -> Optional["ShmRing"]:
        """O_CREAT|O_EXCL producer-side create; None when the name
        already exists (another sender won the race) or shm failed."""
        lib = load_library()
        h = lib.shmring_create(name.encode(), capacity, producer_pid)
        return cls(h, name) if h else None

    @classmethod
    def attach(cls, name: str,
               consumer_pid: int = 0) -> Optional["ShmRing"]:
        """Consumer-side attach; None while the ring does not exist
        yet (callers retry — the producer creates lazily)."""
        lib = load_library()
        h = lib.shmring_attach(name.encode(), consumer_pid)
        return cls(h, name) if h else None

    @staticmethod
    def unlink(name: str) -> None:
        try:
            load_library().shmring_unlink(name.encode())
        except Exception:
            pass  # best-effort cleanup

    def _handle(self):
        h = self._h
        if not h:
            raise MPIError(ErrorCode.ERR_OTHER, "shm ring is closed")
        return h

    @property
    def capacity(self) -> int:
        return self._lib.shmring_capacity(self._handle())

    def pending(self) -> int:
        return self._lib.shmring_pending(self._handle())

    def producer_pid(self) -> int:
        return self._lib.shmring_producer_pid(self._handle())

    def consumer_pid(self) -> int:
        return self._lib.shmring_consumer_pid(self._handle())

    def writev(self, tag: int, parts, timeout_ms: int) -> int:
        ptrs, lens, keep = _sg_arrays(parts)
        rc = self._lib.shmring_writev(self._handle(), tag, ptrs, lens,
                                      len(ptrs), timeout_ms)
        del keep
        return int(rc)

    def read_frag(self, tag: int, xfer: int, nchunks: int, chunk: int,
                  buf, timeout_ms: int) -> int:
        base, nbytes, keep = _wbuf_ptr(buf)
        rc = self._lib.shmring_read_frag(self._handle(), tag, xfer,
                                         nchunks, chunk, base, nbytes,
                                         timeout_ms)
        del keep
        return int(rc)

    def read_into(self, buf, timeout_ms: int):
        """Generic pop of the head record: (status_or_len, tag)."""
        base, nbytes, keep = _wbuf_ptr(buf)
        tag = ctypes.c_int32()
        rc = self._lib.shmring_read_into(self._handle(),
                                         ctypes.byref(tag), base,
                                         nbytes, timeout_ms)
        del keep
        return int(rc), tag.value

    #: shmring_stat index names, in C-side order (native/btl_shm.cc)
    STATS = ("w_frames", "w_bytes", "w_stalls", "w_stall_ns", "hwm",
             "r_frames", "r_bytes", "r_stalls", "r_stall_ns")

    def stats(self) -> dict:
        """The ring header's telemetry block as a dict; all zeros when
        the loaded .so predates the telemetry ABI (pre-v2 rings can't
        exist then either — the magic changed with the layout)."""
        if not hasattr(self._lib, "shmring_stat"):
            return {k: 0 for k in self.STATS}
        h = self._handle()
        return {k: int(self._lib.shmring_stat(h, i))
                for i, k in enumerate(self.STATS)}

    def close(self) -> None:
        if self._h:
            self._lib.shmring_close(self._h)
            self._h = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass


class NativeEventRing:
    """mmap'd fixed-record native event ring ("ompitpu-nativeev-v1").

    One per process, created by the nativewire component when the
    ``wire_native_events`` cvar is on; the C transports append one
    32-byte record per SGC2 fragment once :meth:`install` makes this
    ring the process sink. Drop-oldest wrap: :meth:`read` returns the
    newest ``nslots`` records at most, with the first live sequence so
    consumers can report the gap."""

    #: one record: t_ns u64, xfer u64, tag i32, bytes u32,
    #: idx_dir u32 (bit 31 = receive side), wait_ns u32
    RECORD = struct.Struct("<QQiIII")

    def __init__(self, handle, name: str) -> None:
        self._lib = load_library()
        self._h = handle
        self.name = name

    @classmethod
    def create(cls, name: str,
               nslots: int) -> Optional["NativeEventRing"]:
        lib = load_library()
        if not hasattr(lib, "nativeev_create"):
            return None
        h = lib.nativeev_create(name.encode(), nslots)
        return cls(h, name) if h else None

    @classmethod
    def attach(cls, name: str) -> Optional["NativeEventRing"]:
        lib = load_library()
        if not hasattr(lib, "nativeev_attach"):
            return None
        h = lib.nativeev_attach(name.encode())
        return cls(h, name) if h else None

    @staticmethod
    def unlink(name: str) -> None:
        try:
            load_library().nativeev_unlink(name.encode())
        except Exception:
            pass  # best-effort cleanup

    def _handle(self):
        h = self._h
        if not h:
            raise MPIError(ErrorCode.ERR_OTHER, "event ring is closed")
        return h

    def install(self) -> None:
        """Make this ring the process-global emit sink."""
        self._lib.nativeev_install(self._handle())

    def uninstall(self) -> None:
        self._lib.nativeev_install(None)

    @property
    def nslots(self) -> int:
        return int(self._lib.nativeev_nslots(self._handle()))

    def count(self) -> int:
        """Records ever appended (monotonic across wraps)."""
        return int(self._lib.nativeev_count(self._handle()))

    def read(self, start: int = 0,
             max_records: int = 1 << 16) -> Tuple[int, list]:
        """(first_seq, records) with records decoded to dicts
        ``{t_ns, xfer, tag, bytes, idx, recv, wait_ns}``; first_seq is
        the sequence of records[0] (> start when the ring lapped)."""
        n = min(max_records, self.nslots)
        buf = ctypes.create_string_buffer(n * self.RECORD.size)
        first = ctypes.c_int64(0)
        got = int(self._lib.nativeev_read(
            self._handle(), start,
            ctypes.cast(buf, ctypes.c_void_p), n, ctypes.byref(first)))
        recs = []
        for i in range(got):
            t_ns, xfer, tag, nbytes, idx_dir, wait_ns = \
                self.RECORD.unpack_from(buf, i * self.RECORD.size)
            recs.append({
                "t_ns": t_ns, "xfer": xfer, "tag": tag,
                "bytes": nbytes, "idx": idx_dir & 0x7FFFFFFF,
                "recv": bool(idx_dir >> 31), "wait_ns": wait_ns,
            })
        return int(first.value), recs

    def close(self) -> None:
        if self._h:
            self._lib.nativeev_close(self._h)
            self._h = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass


class PlanExec:
    """Native executor for ONE frozen wire plan (coll/plan analogue of
    the reference's posted-descriptor progress loop).

    coll/native_exec.py compiles a WirePlan into a flat descriptor
    blob (rounds, peers, precomposed header bytes, scatter-gather
    payload maps, pool placements), creates a PlanExec once, binds the
    live endpoint/ring handles once, and then every steady-state fire
    is ``fire_begin`` + a ``fire_step`` loop: all rounds walk C-side,
    Python re-enters only between ~100 ms slices (to honour the
    plan's timeout and run the ULFM ``check_wait``), when the fault
    word is raised, and at completion or typed error.

    Return codes (native/planexec.cc): 0 done, 1 slice expired
    (call ``fire_step`` again), 2 fault-word stop (run check_wait,
    then resume), -1 bad call, -2 peer dead (``err_peer`` names the
    pidx), -3 plan timeout, -4 inbound header diverged from the
    frozen expectation, -5 reassembled payload failed CRC."""

    RC_DONE = 0
    RC_AGAIN = 1
    RC_FTSTOP = 2
    RC_BADARG = -1
    RC_PEERDEAD = -2
    RC_TIMEOUT = -3
    RC_DIVERGED = -4
    RC_TRUNCATED = -5

    def __init__(self, blob: bytes) -> None:
        lib = load_library()
        if not hasattr(lib, "planexec_create"):
            raise MPIError(ErrorCode.ERR_OTHER,
                           "planexec symbols not available")
        self._lib = lib
        self._h = lib.planexec_create(_u8(blob), len(blob))
        if not self._h:
            raise MPIError(ErrorCode.ERR_OTHER,
                           "plan descriptor blob rejected")
        self._ftword = None  # keepalive for the fault-word buffer

    def _handle(self):
        h = self._h
        if not h:
            raise MPIError(ErrorCode.ERR_OTHER, "plan executor closed")
        return h

    def bind(self, ep_handle, my_nid: int, peer_nids,
             tx_ring_handles, rx_ring_handles) -> None:
        """Attach the live endpoint + per-peer ring handles (entries
        may be None → that peer uses the vectored-socket leg)."""
        n = len(peer_nids)
        nids = (ctypes.c_int64 * n)(*[int(v) for v in peer_nids])
        tx = (ctypes.c_void_p * n)(*[h or None
                                     for h in tx_ring_handles])
        rx = (ctypes.c_void_p * n)(*[h or None
                                     for h in rx_ring_handles])
        rc = self._lib.planexec_bind(self._handle(), ep_handle,
                                     my_nid, nids, tx, rx, n)
        if rc != 0:
            raise MPIError(ErrorCode.ERR_OTHER,
                           "plan executor bind rejected")

    def set_ftword(self, word_buf) -> None:
        """Point the executor at a 1-element int64 fault word (a
        ctypes int64 array owned by the caller; nonzero aborts waits
        with RC_FTSTOP within the polling interval)."""
        self._ftword = word_buf
        self._lib.planexec_set_ftword(
            self._handle(),
            ctypes.cast(word_buf, ctypes.POINTER(ctypes.c_int64)))

    def fire_begin(self, input_arrays, xfer_base: int,
                   timeout_ms: int) -> int:
        """Arm a fire with the round-0 input regions (contiguous
        ndarrays, pointers live until the fire completes)."""
        n = len(input_arrays)
        ptrs = (ctypes.c_void_p * n)()
        lens = (ctypes.c_int64 * n)()
        for i, a in enumerate(input_arrays):
            ptrs[i] = ctypes.c_void_p(a.ctypes.data)
            lens[i] = int(a.nbytes)
        self._fire_keep = input_arrays
        return int(self._lib.planexec_fire_begin(
            self._handle(), ptrs, lens, n, xfer_base, timeout_ms))

    def fire_step(self, slice_ms: int) -> int:
        return int(self._lib.planexec_fire_step(self._handle(),
                                                slice_ms))

    @property
    def pool_total(self) -> int:
        return int(self._lib.planexec_pool_total(self._handle()))

    @property
    def pool_count(self) -> int:
        return int(self._lib.planexec_pool_count(self._handle()))

    @property
    def round_count(self) -> int:
        return int(self._lib.planexec_round_count(self._handle()))

    @property
    def input_count(self) -> int:
        return int(self._lib.planexec_input_count(self._handle()))

    def pool_view(self):
        """Zero-copy uint8 ndarray over the reassembly slab (valid
        until close; reused across fires — consumers copy out)."""
        import numpy as _np

        total = self.pool_total
        if total == 0:
            return _np.empty(0, dtype=_np.uint8)
        ptr = self._lib.planexec_pool_ptr(self._handle())
        buf = (ctypes.c_uint8 * total).from_address(ptr)
        return _np.frombuffer(buf, dtype=_np.uint8)

    def round_ts(self):
        """Per-round CLOCK_MONOTONIC end stamps from the last fire —
        the same clock as time.perf_counter, so the obs ledger record
        consumes them unchanged."""
        n = self.round_count
        p = self._lib.planexec_ts_ptr(self._handle())
        return [float(p[i]) for i in range(n)]

    def err_peer(self) -> int:
        return int(self._lib.planexec_err_peer(self._handle()))

    def err_round(self) -> int:
        return int(self._lib.planexec_err_round(self._handle()))

    def drain_stash(self):
        """Pop any foreign frames the executor met on the coll
        channel: list of (kind, peer_pidx, tag, bytes) with kind 0 =
        endpoint-queue frame, 1 = shm-ring record. The caller
        re-injects them into the btl stashes so cross-channel traffic
        survives a native fire untouched."""
        h = self._handle()
        out = []
        n = int(self._lib.planexec_stash_count(h))
        kind = ctypes.c_int64()
        peer = ctypes.c_int64()
        tag = ctypes.c_int64()
        for i in range(n):
            ln = int(self._lib.planexec_stash_info(
                h, i, ctypes.byref(kind), ctypes.byref(peer),
                ctypes.byref(tag)))
            if ln < 0:
                continue
            ptr = self._lib.planexec_stash_data(h, i)
            data = ctypes.string_at(ptr, ln) if ln else b""
            out.append((int(kind.value), int(peer.value),
                        int(tag.value), data))
        self._lib.planexec_stash_clear(h)
        return out

    def close(self) -> None:
        if self._h:
            self._lib.planexec_destroy(self._h)
            self._h = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass
