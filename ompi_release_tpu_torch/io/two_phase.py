"""Cross-process collective IO — a real two-phase exchange, then write.

Counterpart of ``ompi_release_tpu/io/two_phase.py``. The reference's
``fcoll/two_phase``
(``ompi/mca/fcoll/two_phase/fcoll_two_phase_file_write_all.c``)
partitions the file's touched range into contiguous *file domains*, one
per aggregator; every rank ships the pieces of its blocks that fall in
aggregator p's domain to p, and each aggregator writes its domain with
large coalesced IOs. Under the unified ``tpurun`` world each process
holds only its LOCAL members' blocks, so this module does the exchange
over the wire's per-communicator collective channels:

  phase 0  allgather the global (offset, count) table (every process
           learns the touched range and every rank's extent);
  phase 1  split local blocks by file domain; linear exchange — one
           segment-table message + one data message per peer (all sends
           land before any receive parks);
  phase 2  each aggregator coalesces its domain's segments (sorted,
           adjacent runs merged into NEW host arrays: nothing is folded
           into a view of a caller's buffer) and writes them through the
           view (``File.write_at`` maps visible elements to file bytes,
           holes included).

Reads run the phases in reverse: aggregators read their domain's
segments and ship them back to the requesting member's process.

Offsets/counts are VISIBLE-element positions in the current view, so
interleaved holey views from different processes tile the same file
extents exactly as ``io/romio``'s aggregated case. A block on the card
is read to the host once (``File._host``); the file bytes are the JAX
package's for the same blocks.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..runtime.wire import ProcTopology as _Topology
from ..runtime.wire import proc_topology as _topology
from ..utils.errors import ErrorCode, MPIError


def _np(x) -> np.ndarray:
    """A host payload off the wire as numpy."""
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _global_table(comm, topo: _Topology, offsets, counts) -> np.ndarray:
    """(n, 2) int64 rows of (offset, count) per comm rank, exchanged as
    raw numpy over the wire channel (file element offsets must not
    truncate at 2^31)."""
    local = np.asarray(
        [[int(o), int(c)] for o, c in zip(offsets, counts)], np.int64
    ).reshape(topo.local_n, 2)
    for p in topo.peers:
        topo.router.coll_send(comm, p, local)
    rows: Dict[int, np.ndarray] = {topo.my_pidx: local}
    for p in topo.peers:
        rows[p] = _np(topo.router.coll_recv(comm, p))
    table = np.zeros((comm.size, 2), np.int64)
    for p in topo.procs:
        for pos, r in enumerate(topo.members_of[p]):
            table[r] = rows[p][pos]
    return table


def _domains(table: np.ndarray, procs: List[int]
             ) -> Dict[int, Tuple[int, int]]:
    """Contiguous per-aggregator file domains covering the touched
    visible-element range (two_phase's fd_start/fd_end)."""
    active = table[table[:, 1] > 0]
    if active.size == 0:
        return {p: (0, 0) for p in procs}
    lo = int(active[:, 0].min())
    hi = int((active[:, 0] + active[:, 1]).max())
    span = hi - lo
    k = len(procs)
    chunk = -(-span // k) if span else 0
    return {
        p: (lo + i * chunk, min(lo + (i + 1) * chunk, hi))
        for i, p in enumerate(procs)
    }


def _split_segments(topo: _Topology, doms: Dict[int, Tuple[int, int]],
                    offsets, blocks, etype) -> Dict[int, list]:
    """Cut each local member's block by file domain:
    {aggregator: [(seg_offset, seg_array)]}."""
    segs: Dict[int, list] = {p: [] for p in topo.procs}
    for o, blk in zip(offsets, blocks):
        o = int(o)
        arr = np.ascontiguousarray(np.asarray(blk, etype)).reshape(-1)
        for p, (dlo, dhi) in doms.items():
            s = max(o, dlo)
            e = min(o + arr.size, dhi)
            if s < e:
                segs[p].append((s, arr[s - o:e - o]))
    return segs


def _pack_segs(segs: list, etype) -> Tuple[np.ndarray, np.ndarray]:
    """(m, 2) int64 table of (offset, len) + concatenated data."""
    table = np.asarray([[s, a.size] for s, a in segs],
                       np.int64).reshape(len(segs), 2)
    data = (np.concatenate([a for _, a in segs])
            if segs else np.empty(0, etype))
    return table, data


def _coalesce(segs: list) -> list:
    """Sort by offset and merge adjacent runs (two_phase writes each
    domain with few large IOs, not one per incoming piece). Overlaps
    (undefined in MPI) resolve last-writer-wins via apply order."""
    if not segs:
        return []
    segs = sorted(segs, key=lambda s: s[0])
    out = [segs[0]]
    for o, a in segs[1:]:
        po, pa = out[-1]
        if o == po + pa.size:
            out[-1] = (po, np.concatenate([pa, a]))
        else:
            out.append((o, a))
    return out


def write_at_all(file, offsets, blocks) -> int:
    """Spanning-comm MPI_File_write_at_all: ``offsets``/``blocks``
    carry one entry per LOCAL member (visible-element offsets in the
    current view). Returns the GLOBAL element count written."""
    comm = file.comm
    topo = _topology(comm)
    if len(offsets) != topo.local_n or len(blocks) != topo.local_n:
        raise MPIError(
            ErrorCode.ERR_ARG,
            f"spanning write_at_all needs one offset/block per LOCAL "
            f"member ({topo.local_n}), got {len(offsets)}/{len(blocks)}",
        )
    etype = file._etype
    arrs = [file._host(b).reshape(-1) for b in blocks]
    table = _global_table(comm, topo, offsets,
                          [a.size for a in arrs])
    doms = _domains(table, topo.procs)
    segs = _split_segments(topo, doms, offsets, arrs, etype)

    # linear exchange: segment table + data to every peer, then
    # receive the same pair from each (all sends first — deadlock-free
    # for the linear pattern, as in coll/hier._exchange)
    for p in topo.peers:
        t, d = _pack_segs(segs[p], etype)
        topo.router.coll_send(comm, p, t)
        topo.router.coll_send(comm, p, d)
    mine = list(segs[topo.my_pidx])
    for p in topo.peers:
        t = _np(topo.router.coll_recv(comm, p))
        d = _np(topo.router.coll_recv(comm, p)).astype(etype, copy=False)
        off = 0
        for s, ln in t.reshape(-1, 2):
            mine.append((int(s), d[off:off + int(ln)]))
            off += int(ln)

    for o, a in _coalesce(mine):
        file.write_at(o, a)
    comm.barrier()  # collective completion (fcoll's end-of-phase sync)
    return int(table[:, 1].sum())


def read_at_all(file, offsets, counts) -> List[np.ndarray]:
    """Spanning-comm MPI_File_read_at_all: aggregators read their
    file domain once and ship each member's pieces back. Returns one
    array per LOCAL member."""
    comm = file.comm
    topo = _topology(comm)
    if len(offsets) != topo.local_n or len(counts) != topo.local_n:
        raise MPIError(
            ErrorCode.ERR_ARG,
            f"spanning read_at_all needs one offset/count per LOCAL "
            f"member ({topo.local_n}), got {len(offsets)}/{len(counts)}",
        )
    etype = file._etype
    counts = [int(c) for c in counts]
    table = _global_table(comm, topo, offsets, counts)
    doms = _domains(table, topo.procs)

    # which segments each process wants from each aggregator (derived
    # from the global table — no request messages needed; both sides
    # compute the identical plan, the two_phase offset-list exchange
    # collapsed into shared arithmetic)
    def wanted(proc: int) -> Dict[int, list]:
        """{aggregator: [(member_pos, seg_offset, seg_len)]} for
        ``proc``'s members, in deterministic order."""
        want: Dict[int, list] = {p: [] for p in topo.procs}
        for pos, r in enumerate(topo.members_of[proc]):
            o, c = int(table[r, 0]), int(table[r, 1])
            for p, (dlo, dhi) in doms.items():
                s = max(o, dlo)
                e = min(o + c, dhi)
                if s < e:
                    want[p].append((pos, s, e - s))
        return want

    # read ONLY the wanted extents of my domain (merged where they
    # overlap/touch): a sparse request pattern must not amplify into
    # reading the whole contiguous domain span
    import bisect

    spans = sorted(
        (s, ln) for p in topo.procs
        for _, s, ln in wanted(p)[topo.my_pidx]
    )
    runs: List[list] = []
    for s, ln in spans:
        if runs and s <= runs[-1][0] + runs[-1][1]:
            runs[-1][1] = max(runs[-1][1], s + ln - runs[-1][0])
        else:
            runs.append([s, ln])
    run_data: Dict[int, np.ndarray] = {}
    for s, ln in runs:
        arr = file.read_at(s, ln)
        if arr.size < ln:
            raise MPIError(
                ErrorCode.ERR_FILE,
                f"read_at_all: file ends inside requested extent "
                f"[{s}, {s + ln}) ({arr.size} of {ln} elements)",
            )
        run_data[s] = arr
    run_starts = [s for s, _ in runs]

    def piece(s: int, ln: int) -> np.ndarray:
        rs = run_starts[bisect.bisect_right(run_starts, s) - 1]
        return run_data[rs][s - rs:s - rs + ln]

    # serve every peer's pieces from my domain (deterministic order),
    # then collect my members' pieces from each aggregator
    for p in topo.peers:
        pieces = [piece(s, ln) for _, s, ln in wanted(p)[topo.my_pidx]]
        topo.router.coll_send(
            comm, p,
            np.concatenate(pieces) if pieces else np.empty(0, etype),
        )
    my_want = wanted(topo.my_pidx)
    out = [np.empty(c, etype) for c in counts]
    for pos, s, ln in my_want[topo.my_pidx]:  # my own domain's pieces
        o = int(table[topo.local_ranks[pos], 0])
        out[pos][s - o:s - o + ln] = piece(s, ln)
    for p in topo.peers:
        d = _np(topo.router.coll_recv(comm, p)).astype(etype, copy=False)
        off = 0
        for pos, s, ln in my_want[p]:
            o = int(table[topo.local_ranks[pos], 0])
            out[pos][s - o:s - o + ln] = d[off:off + ln]
            off += ln
    comm.barrier()
    return [np.asarray(a) for a in out]
