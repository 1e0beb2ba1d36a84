"""MPI_File API over host files — the ompio surface, in-process.

Counterpart of ``ompi_release_tpu/io/file.py`` (host numpy and ``os``):
the surface of ``ompi/mca/io`` (open/close/read_at/write_at/read_all/
write_all/shared pointer/set_view) with ompio's component split honored
in miniature: fs = python file open/close per rank handle, fbtl =
individual pread/pwrite at explicit offsets, fcoll = collective
write_all/read_all where every rank's block lands at its view offset
(the two-phase exchange is unnecessary when one controller already holds
every rank's block), sharedfp = an ordered shared file pointer.

Views: ``set_view(disp, etype, filetype)`` accepts a full
:class:`~..datatype.datatype.Datatype` filetype WITH holes (``io/romio``
file views): each rank's strided runs are written/read directly per
contiguous run. Nonblocking ops (``iwrite_at``/``iread_at``/
``iwrite_at_all``/``iread_at_all``) run on a per-file thread pool and
return Requests whose errors surface at ``wait``. A tensor on the card
is read to the host per block (``utils/arrays.to_numpy``). On a
communicator spanning controller processes the collective calls take one
entry per LOCAL member and run the two-phase exchange over the wire
(``io/two_phase.py``) in the comm's collective posting order; the shared
file pointer stays refused there, as in the JAX package.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np

from ..request.request import Request
from ..utils.arrays import to_numpy
from ..utils.errors import ErrorCode, MPIError

MODE_RDONLY = os.O_RDONLY
MODE_WRONLY = os.O_WRONLY
MODE_RDWR = os.O_RDWR
MODE_CREATE = os.O_CREAT


class File:
    """MPI_File analogue bound to a communicator."""

    def __init__(self, comm, path: str,
                 mode: int = MODE_RDWR | MODE_CREATE) -> None:
        self.comm = comm
        self.path = path
        try:
            self._fd = os.open(path, mode, 0o644)
        except OSError as e:
            raise MPIError(ErrorCode.ERR_FILE, f"open {path}: {e}")
        self._lock = threading.Lock()
        self._shared_ptr = 0  # sharedfp analogue
        # view: (displacement bytes, elementary dtype, filetype)
        self._disp = 0
        self._etype = np.dtype(np.uint8)
        self._filetype = None
        self._ft_runs: Optional[np.ndarray] = None  # (start, len) pairs
        self._ft_size = 0    # visible elements per tile
        self._ft_extent = 0  # tile extent in etype elements
        self._closed = False
        self._pool: Optional[ThreadPoolExecutor] = None

    # -- view (MPI_File_set_view) -----------------------------------------
    def set_view(self, disp: int = 0, etype=np.uint8,
                 filetype=None) -> None:
        """Install the view: from ``disp`` bytes on, the file is a
        tiling of ``filetype`` (a :class:`Datatype`, possibly with
        holes); only the filetype's data regions are addressable and
        element offsets count VISIBLE etype elements (the ROMIO view
        contract). ``filetype=None`` = contiguous etype stream."""
        self._disp = int(disp)
        self._etype = np.dtype(etype)
        self._filetype = filetype
        if filetype is None:
            self._ft_runs = None
            return
        offs = np.asarray(filetype.offsets(1), dtype=np.int64)
        if offs.size == 0:
            raise MPIError(ErrorCode.ERR_TYPE,
                           "filetype has no data elements")
        base = getattr(filetype, "base_dtype", None)
        if base is not None and base.itemsize != self._etype.itemsize:
            raise MPIError(
                ErrorCode.ERR_TYPE,
                f"filetype base ({base}) and etype "
                f"({self._etype}) sizes differ — MPI requires the "
                "filetype be constructed from the etype",
            )
        # contiguous runs within one tile: (start_elem, run_len)
        runs = []
        start = prev = int(offs[0])
        for o in offs[1:]:
            o = int(o)
            if o == prev + 1:
                prev = o
                continue
            runs.append((start, prev - start + 1))
            start = prev = o
        runs.append((start, prev - start + 1))
        self._ft_runs = np.asarray(runs, dtype=np.int64)
        self._ft_size = int(offs.size)
        self._ft_extent = int(filetype.get_extent())

    def _byte_offset(self, offset_elems: int) -> int:
        return self._disp + offset_elems * self._etype.itemsize

    def _view_ranges(self, start_elem: int, count: int):
        """Yield (byte_offset, elem_count) contiguous file runs for
        ``count`` visible elements from view position ``start_elem``
        (identity when no filetype is installed)."""
        if self._ft_runs is None:
            yield self._byte_offset(start_elem), count
            return
        pos = start_elem
        remaining = count
        while remaining > 0:
            tile, idx = divmod(pos, self._ft_size)
            # find the run containing visible index idx
            seen = 0
            for rstart, rlen in self._ft_runs:
                if idx < seen + rlen:
                    within = idx - seen
                    take = min(int(rlen) - within, remaining)
                    file_elem = (tile * self._ft_extent + int(rstart)
                                 + within)
                    yield self._byte_offset(file_elem), take
                    pos += take
                    remaining -= take
                    break
                seen += int(rlen)

    def _check(self) -> None:
        if self._closed:
            raise MPIError(ErrorCode.ERR_FILE, f"{self.path} closed")

    def _host(self, data) -> np.ndarray:
        """A C-ordered host copy of ``data`` in the etype (a tensor on
        the card is read to the host here)."""
        return np.ascontiguousarray(np.asarray(to_numpy(data), self._etype))

    # -- individual (fbtl) -------------------------------------------------
    def write_at(self, offset: int, data) -> int:
        """pwrite at a visible-element offset in the current view
        (with a holey filetype this scatters per contiguous run)."""
        self._check()
        buf = self._host(data).reshape(-1)
        isz = self._etype.itemsize
        raw = buf.tobytes()
        done = 0
        written = 0
        for byte_off, n_elems in self._view_ranges(offset, buf.size):
            written += os.pwrite(
                self._fd, raw[done * isz:(done + n_elems) * isz],
                byte_off,
            )
            done += n_elems
        return written // isz

    def read_at(self, offset: int, count: int) -> np.ndarray:
        self._check()
        isz = self._etype.itemsize
        parts = []
        for byte_off, n_elems in self._view_ranges(offset, count):
            raw = os.pread(self._fd, n_elems * isz, byte_off)
            parts.append(np.frombuffer(raw, self._etype))
            if len(raw) < n_elems * isz:
                break  # EOF inside a run: later runs are past it too
        if not parts:
            return np.empty(0, self._etype)
        return (parts[0].copy() if len(parts) == 1
                else np.concatenate(parts))

    # -- collective (fcoll) ------------------------------------------------
    def write_at_all(self, offsets, blocks) -> int:
        """Collective write: rank i's block at element offset i
        (driver mode: per-rank lists). Disjoint contiguous extents per
        rank = the post-aggregation phase of fcoll/two_phase. The
        per-rank pwrites are issued concurrently (os.pwrite releases
        the GIL), matching the aggregators-write-in-parallel phase.

        On a communicator spanning controller processes the lists carry
        one entry per LOCAL member and the two-phase exchange runs over
        the wire (``io/two_phase.py``)."""
        self._check()
        if getattr(self.comm, "spans_processes", False):
            from . import two_phase

            # through the comm's collective posting order: the exchange
            # shares the comm's wire channel with every other collective
            return self.comm._run_serialized(
                two_phase.write_at_all, self, offsets, blocks)
        if len(offsets) != self.comm.size or len(blocks) != self.comm.size:
            raise MPIError(
                ErrorCode.ERR_ARG,
                f"need {self.comm.size} offsets/blocks (one per rank)",
            )
        with ThreadPoolExecutor(
            max_workers=min(self.comm.size, 16)
        ) as pool:
            total = sum(pool.map(
                lambda ob: self.write_at(ob[0], ob[1]),
                zip(offsets, blocks),
            ))
        self.comm.barrier()
        return total

    def read_at_all(self, offsets, counts):
        self._check()
        if getattr(self.comm, "spans_processes", False):
            from . import two_phase

            return self.comm._run_serialized(
                two_phase.read_at_all, self, offsets, counts)
        if len(offsets) != self.comm.size or len(counts) != self.comm.size:
            raise MPIError(
                ErrorCode.ERR_ARG,
                f"need {self.comm.size} offsets/counts (one per rank)",
            )
        with ThreadPoolExecutor(
            max_workers=min(self.comm.size, 16)
        ) as pool:
            out = list(pool.map(
                lambda oc: self.read_at(oc[0], oc[1]),
                zip(offsets, counts),
            ))
        self.comm.barrier()
        return out

    # -- nonblocking (MPI_File_iwrite_at family) ---------------------------
    def _io_pool(self) -> ThreadPoolExecutor:
        with self._lock:  # two first-op threads must share ONE pool
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=4,
                    thread_name_prefix=f"io-{os.path.basename(self.path)}",
                )
            return self._pool

    @staticmethod
    def _future_request(fut: Future) -> Request:
        """The generic future wrapper plus IO's element-count Status
        (``MPI_Get_count`` on a file request)."""
        from ..request.request import from_future

        req = from_future(fut)

        def _count(r: Request) -> None:
            v = r.value
            r.status.count = (int(v) if isinstance(v, int)
                              else int(getattr(v, "size", 0)))

        req.on_complete(_count)
        return req

    def iwrite_at(self, offset: int, data) -> Request:
        """Nonblocking write_at: returns a Request whose value is the
        element count written."""
        self._check()
        buf = self._host(data)
        return self._future_request(
            self._io_pool().submit(self.write_at, offset, buf)
        )

    def iread_at(self, offset: int, count: int) -> Request:
        """Nonblocking read_at: the Request's value is the array."""
        self._check()
        return self._future_request(
            self._io_pool().submit(self.read_at, offset, count)
        )

    def iwrite_at_all(self, offsets, blocks) -> Request:
        """Nonblocking collective write (MPI_File_iwrite_at_all): the
        whole fcoll exchange runs on the pool thread; collective
        ordering across the communicator is the caller's duty, as in
        MPI. On a spanning comm it posts to the comm's schedule queue
        (the 4-worker io pool would reorder two outstanding collectives
        between posting and execution)."""
        self._check()
        blocks = [self._host(b) for b in blocks]
        if getattr(self.comm, "spans_processes", False):
            from . import two_phase

            return self.comm._submit_serialized(
                two_phase.write_at_all, self, offsets, blocks)
        return self._future_request(
            self._io_pool().submit(self.write_at_all, offsets, blocks)
        )

    def iread_at_all(self, offsets, counts) -> Request:
        self._check()
        if getattr(self.comm, "spans_processes", False):
            from . import two_phase

            return self.comm._submit_serialized(
                two_phase.read_at_all, self, offsets, counts)
        return self._future_request(
            self._io_pool().submit(self.read_at_all, offsets, counts)
        )

    # -- shared file pointer (sharedfp) ------------------------------------
    def _require_single_process(self, what: str) -> None:
        """The shared pointer is PROCESS-local state (``self._shared_
        ptr`` under ``self._lock``); on a communicator spanning
        controller processes each process would advance its OWN copy
        and two ranks' appends would silently land at the same offset.
        Until the pointer lives in a wire-window (the sharedfp/sm ->
        lockedfile gap), refuse loudly instead of corrupting."""
        if getattr(self.comm, "spans_processes", False):
            raise MPIError(
                ErrorCode.ERR_NOT_AVAILABLE,
                f"{what} on {self.comm.name}: the shared file pointer "
                "is process-local, but this communicator spans "
                "controller processes — concurrent shared-pointer ops "
                "from different processes would silently overlap. Use "
                "explicit-offset writes (write_at/write_at_all) or a "
                "process-local comm",
            )

    def write_ordered(self, blocks) -> None:
        """Rank-ordered append at the shared pointer (sharedfp
        'ordered' semantics)."""
        self._check()
        self._require_single_process("write_ordered")
        self._append_at_shared(blocks)

    def _append_at_shared(self, blocks) -> None:
        """Shared-pointer append, checks done by the public caller
        (so each entry point reports its own name exactly once)."""
        with self._lock:
            for blk in blocks:
                buf = self._host(blk)
                os.pwrite(self._fd, buf.tobytes(),
                          self._byte_offset(self._shared_ptr))
                self._shared_ptr += buf.size

    def read_ordered(self, counts) -> list:
        """Rank-ordered read at the shared pointer (MPI_File_read_
        ordered): rank i's buffer is the ``counts[i]`` elements
        starting where rank i-1's read ended; the pointer advances by
        the amount actually read (MPI's accessed-amount semantics, so
        an EOF short read leaves the pointer at EOF rather than past
        data appended later). Driver mode holds every rank, so the
        whole ordered pass is one call returning one array per rank."""
        self._check()
        self._require_single_process("read_ordered")
        counts = [int(c) for c in counts]
        if any(c < 0 for c in counts):
            raise MPIError(ErrorCode.ERR_COUNT,
                           f"read_ordered counts must be >= 0: {counts}")
        with self._lock:
            out = []
            for c in counts:
                arr = self.read_at(self._shared_ptr, c)
                out.append(arr)
                self._shared_ptr += arr.size
        return out

    def write_shared(self, data) -> int:
        """Append one buffer at the shared pointer (sharedfp
        non-ordered write: first-come placement) — one rank's
        write_ordered, sharing the placement logic."""
        self._check()
        self._require_single_process("write_shared")
        buf = self._host(data)
        self._append_at_shared([buf])
        return int(buf.size)  # not a pointer diff: races with other
        #                       shared-pointer writers would misreport

    def read_shared(self, count: int) -> np.ndarray:
        self._check()
        self._require_single_process("read_shared")
        with self._lock:
            out = self.read_at(self._shared_ptr, count)
            self._shared_ptr += out.size  # amount accessed, not requested
        return out

    # -- admin -------------------------------------------------------------
    def size(self) -> int:
        self._check()
        return os.fstat(self._fd).st_size

    def preallocate(self, nbytes: int) -> None:
        self._check()
        os.ftruncate(self._fd, nbytes)

    def sync(self) -> None:
        self._check()
        os.fsync(self._fd)

    def close(self) -> None:
        if not self._closed:
            if self._pool is not None:
                # MPI_File_close completes outstanding nonblocking ops
                self._pool.shutdown(wait=True)
                self._pool = None
            os.close(self._fd)
            self._closed = True

    @staticmethod
    def delete(path: str) -> None:
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
