"""Intercommunicators — ``MPI_Intercomm_create/merge`` + ``coll/inter``.

Counterpart of ``ompi_release_tpu/comm/intercomm.py`` (reference:
intercommunicator construction and merge in ``ompi/communicator/comm.c``,
inter-collective semantics in ``ompi/mca/coll/inter/coll_inter.c``).

An intercommunicator binds a *local* group and a disjoint *remote*
group; collectives have cross-group semantics (data always flows between
the groups, never within one). As in the reference, inter-collectives
compose intra-collectives: each runs as an ordinary collective over one
group's communicator (or over the *bridge*, the intra-communicator over
local + remote), so every large f32/bf16 SUM in them runs the CUDA
streaming kernel and every call goes through ``coll/plan.py``.

Driver-mode conventions match :class:`Communicator`: one controller
plays every rank, so cross-group ops take both sides' buffers (leading
axis = that group's size) and results are reported from the handle's
perspective (what *local* ranks receive). Every intercommunicator is
created as a mirrored pair sharing one bridge; ``mirror`` is the remote
side's handle. ``comm/dpm.py``'s connect/accept builds its pairs through
:meth:`Intercommunicator.create` with a ``cid_block`` under tpurun: only
the processes taking part build such a pair, so its cids (and those of
every comm derived from it) come from a block the port's owner reserved
and sent to the connector, never from the shared counter.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils import output
from ..utils.errors import ErrorCode, MPIError
from .communicator import CidBlock, Communicator
from .group import Group

_log = output.stream("comm")


class Intercommunicator(Communicator):
    """One side's handle of an intercommunicator pair.

    ``group`` (inherited) is the LOCAL group; ``remote_group`` is the
    other side. ``size``/``rank_of`` follow MPI: they describe the local
    group; ``remote_size`` describes the remote group.
    """

    is_inter = True

    def __init__(self, runtime, local_group: Group, remote_group: Group,
                 *, name: str = "", parent: Optional[Communicator] = None,
                 _bridge: Optional[Communicator] = None,
                 cid_block: Optional[CidBlock] = None) -> None:
        overlap = set(local_group.world_ranks) & set(remote_group.world_ranks)
        if overlap:
            raise MPIError(
                ErrorCode.ERR_GROUP,
                f"intercomm groups must be disjoint; overlap={sorted(overlap)}",
            )
        if local_group.size == 0 or remote_group.size == 0:
            raise MPIError(ErrorCode.ERR_GROUP,
                           "intercomm groups must be non-empty")
        self.remote_group = remote_group
        super().__init__(runtime, local_group, name=name, parent=parent,
                         cid_block=cid_block)
        # the bridge is an ordinary intra-communicator over local+remote
        # in that order — the substrate both perspectives share
        if _bridge is None:
            _bridge = Communicator(
                runtime,
                Group(local_group.world_ranks + remote_group.world_ranks),
                name=f"bridge({self.name})", parent=parent,
                cid_block=self.cid_block,
            )
        self._bridge = _bridge
        self.mirror: Optional["Intercommunicator"] = None  # set by create

    # -- queries ----------------------------------------------------------
    @property
    def remote_size(self) -> int:
        return self.remote_group.size

    # -- construction -----------------------------------------------------
    @classmethod
    def create(cls, runtime, group_a: Group, group_b: Group, *,
               name: str = "", parent: Optional[Communicator] = None,
               cid_block: Optional[CidBlock] = None,
               ) -> Tuple["Intercommunicator", "Intercommunicator"]:
        """Build the mirrored pair (side A's handle, side B's handle);
        three cids in this order: A, the bridge, B."""
        ia = cls(runtime, group_a, group_b, name=name or "intercomm",
                 parent=parent, cid_block=cid_block)
        ib = cls(runtime, group_b, group_a, name=f"{ia.name}~mirror",
                 parent=parent, _bridge=ia._bridge, cid_block=cid_block)
        ia.mirror, ib.mirror = ib, ia
        return ia, ib

    def merge(self, high: bool = False) -> Communicator:
        """``MPI_Intercomm_merge``: intra-communicator over the union.
        ``high`` is this side's vote: the low group's ranks come first
        (``comm.c`` ompi_intercomm_merge ordering)."""
        self._check_alive()
        first, second = (
            (self.remote_group, self.group) if high
            else (self.group, self.remote_group)
        )
        return Communicator(
            self.runtime,
            Group(first.world_ranks + second.world_ranks),
            name=f"merge({self.name})", parent=self,
        )

    # -- inter collectives (coll/inter analogue) --------------------------
    # All take driver-mode buffers: *_local has leading axis = local size,
    # *_remote leading axis = remote size. Results are what the LOCAL side
    # receives.
    def _local_comm(self) -> Communicator:
        c = getattr(self, "_local_intra", None)
        if c is None:
            c = Communicator(self.runtime, self.group,
                             name=f"local({self.name})", parent=self)
            self._local_intra = c
        return c

    def _remote_comm(self) -> Communicator:
        # the mirror's local comm, so cached bodies and plans are shared
        if self.mirror is not None:
            return self.mirror._local_comm()
        c = getattr(self, "_remote_intra", None)
        if c is None:
            c = Communicator(self.runtime, self.remote_group,
                             name=f"remote({self.name})", parent=self)
            self._remote_intra = c
        return c

    def _check_counts(self, bufs, n: int, what: str) -> None:
        if len(bufs) != n:
            raise MPIError(
                ErrorCode.ERR_ARG,
                f"{what} needs {n} per-rank buffers, got {len(bufs)}",
            )

    def barrier(self) -> None:
        """Inter-barrier: no rank leaves until every rank of BOTH groups
        arrived — the bridge's barrier is exactly that."""
        self._check_alive()
        self._bridge.barrier()

    def ibarrier(self):
        """Nonblocking inter-barrier rides the BRIDGE (both groups)."""
        self._check_alive()
        return self._bridge.ibarrier()

    # nonblocking inter variants: each i-op is its blocking form, enqueued
    # on the device, wrapped in a Request completed by an event behind it.
    # The inherited intra i-variants would misbind onto the inter
    # signatures (send_local/send_remote), so every one is overridden.
    def iallgather(self, send_local, send_remote):
        return self._async(self.allgather(send_local, send_remote))

    def iallreduce(self, send_local, send_remote, op=None):
        return self._async(self.allreduce(send_local, send_remote, op))

    def ibcast(self, x, root: int):
        return self._async(self.bcast(x, root))

    def ireduce(self, send_remote, op=None, root: int = 0):
        return self._async(self.reduce(send_remote, op, root))

    def igather(self, send_remote, root: int = 0):
        return self._async(self.gather(send_remote, root))

    def iscatter(self, sendbuf, root: int):
        return self._async(self.scatter(sendbuf, root))

    def ialltoall(self, send_local, send_remote):
        return self._async(self.alltoall(send_local, send_remote))

    def allgather(self, send_local, send_remote):
        """Each local rank receives the remote group's buffers
        concatenated in remote rank order (identical across local ranks
        — returned once, driver convention)."""
        self._check_alive()
        self._check_counts(send_local, self.size, "allgather local")
        self._check_counts(send_remote, self.remote_size, "allgather remote")
        # coll_inter_allgather: intra-gather in the remote group, then
        # deliver across (one device: the result is already local)
        return self._remote_comm().allgather(send_remote)[0]

    def allreduce(self, send_local, send_remote, op=None):
        """Local ranks receive the reduction of the REMOTE group's
        contributions (MPI inter-allreduce semantics). ``send_local`` is
        what OUR ranks contribute to the remote side's result; it is
        validated here and consumed by the remote group's own call."""
        self._check_alive()
        from .. import ops as ops_mod

        self._check_counts(send_local, self.size, "allreduce local")
        self._check_counts(send_remote, self.remote_size, "allreduce remote")
        return self._remote_comm().allreduce(send_remote,
                                             op or ops_mod.SUM)[0]

    def bcast(self, x, root: int):
        """Root is a rank in the REMOTE group (the MPI_ROOT side); local
        ranks receive its buffer: a bridge bcast from the remote root's
        bridge rank."""
        self._check_alive()
        if not 0 <= root < self.remote_size:
            raise MPIError(ErrorCode.ERR_ROOT,
                           f"root {root} not in remote group")
        bridge_root = self._bridge.group.rank_of(
            self.remote_group.world_rank(root)
        )
        x = self._bridge._buf(x)
        placed = x.unsqueeze(0).expand((self._bridge.size,) + tuple(x.shape))
        return self._bridge.bcast(placed.contiguous(), root=bridge_root)[0]

    def reduce(self, send_remote, op=None, root: int = 0):
        """Reduce the REMOTE group's contributions to local rank ``root``
        (this side is the root group). Root-agnostic driver convention:
        the reduction is computed once (as a remote-group allreduce, in
        that allreduce's order) and returned to the caller, who IS every
        local rank; ``root`` is range-validated."""
        self._check_alive()
        from .. import ops as ops_mod

        if not 0 <= root < self.size:
            raise MPIError(ErrorCode.ERR_ROOT,
                           f"root {root} not in local group")
        self._check_counts(send_remote, self.remote_size, "reduce remote")
        return self._remote_comm().allreduce(send_remote,
                                             op or ops_mod.SUM)[0]

    def gather(self, send_remote, root: int = 0):
        """Local rank ``root`` receives the remote group's buffers in
        remote rank order (root-agnostic driver convention as in
        :meth:`reduce`)."""
        self._check_alive()
        if not 0 <= root < self.size:
            raise MPIError(ErrorCode.ERR_ROOT,
                           f"root {root} not in local group")
        self._check_counts(send_remote, self.remote_size, "gather remote")
        return self._remote_comm().allgather(send_remote)[0]

    def scatter(self, sendbuf, root: int):
        """Remote rank ``root`` scatters; local ranks receive one chunk
        each (leading axis of ``sendbuf`` = local size): the local
        group's scatter of the root's buffer."""
        self._check_alive()
        if not 0 <= root < self.remote_size:
            raise MPIError(ErrorCode.ERR_ROOT,
                           f"root {root} not in remote group")
        local = self._local_comm()
        sendbuf = local._buf(sendbuf)
        if sendbuf.shape[0] != self.size:
            raise MPIError(
                ErrorCode.ERR_ARG,
                f"scatter sendbuf leading axis {sendbuf.shape[0]} != "
                f"local size {self.size}",
            )
        n = self.size
        flat = sendbuf.reshape(-1)
        arr = flat.unsqueeze(0).expand(n, flat.numel()).contiguous()
        return local.scatter(arr, root=0).reshape(sendbuf.shape)

    def alltoall(self, send_local, send_remote):
        """Inter-alltoall: local rank i sends ``send_local[i][j]`` to
        remote rank j; returns what local ranks receive —
        ``recv[i][j] = send_remote[j][i]``. Runs as the BRIDGE's
        intra-alltoall with the off-diagonal block pattern (local rows
        only populate remote destinations and vice versa)."""
        self._check_alive()
        send_local = self._bridge._buf(send_local)
        send_remote = self._bridge._buf(send_remote)
        nl, nr = self.size, self.remote_size
        if tuple(send_local.shape[:2]) != (nl, nr):
            raise MPIError(
                ErrorCode.ERR_ARG,
                f"send_local must be (local={nl}, remote={nr}, ...), "
                f"got {tuple(send_local.shape)}",
            )
        if tuple(send_remote.shape[:2]) != (nr, nl):
            raise MPIError(
                ErrorCode.ERR_ARG,
                f"send_remote must be (remote={nr}, local={nl}, ...), "
                f"got {tuple(send_remote.shape)}",
            )
        if send_local.shape[2:] != send_remote.shape[2:]:
            raise MPIError(
                ErrorCode.ERR_ARG,
                "send_local/send_remote chunk shapes differ: "
                f"{tuple(send_local.shape[2:])} vs "
                f"{tuple(send_remote.shape[2:])}",
            )
        n = nl + nr
        trail = tuple(send_local.shape[2:])
        full = send_local.new_zeros((n, n) + trail)
        full[:nl, nl:] = send_local          # local rows -> remote dests
        full[nl:, :nl] = send_remote         # remote rows -> local dests
        # bridge alltoall convention: per-rank slice holds n chunks back
        # to back along the leading axis
        out = self._bridge.alltoall(full.reshape((n, -1) + trail[1:])
                                    if trail else full.reshape(n, n))
        out = out.reshape((n, n) + trail)
        # local rank i's received remote chunks: out[i][nl:]
        return out[:nl, nl:]

    # -- point-to-point (MPI intercomm addressing) -------------------------
    # On an intercommunicator, dest/source are ranks in the REMOTE group
    # (MPI-2 semantics). The inherited Communicator p2p would deliver
    # within the local group — wrong recipient, no error — so every p2p
    # op translates through the bridge comm's PML: local rank -> bridge
    # rank [0, nl), remote rank -> bridge rank [nl, nl+nr).
    def _bridge_local(self, r: int) -> int:
        if not 0 <= r < self.size:
            raise MPIError(ErrorCode.ERR_RANK,
                           f"local rank {r} out of range")
        return self._bridge.group.rank_of(self.group.world_rank(r))

    def _bridge_remote(self, r: int) -> int:
        if not 0 <= r < self.remote_size:
            raise MPIError(ErrorCode.ERR_RANK,
                           f"remote rank {r} out of range")
        return self._bridge.group.rank_of(self.remote_group.world_rank(r))

    def isend(self, data, dest: int, tag: int = 0, *, rank: int, **kw):
        return self._bridge.isend(
            data, self._bridge_remote(dest), tag,
            rank=self._bridge_local(rank), **kw,
        )

    def send(self, data, dest: int, tag: int = 0, *, rank: int, **kw):
        return self._bridge.send(
            data, self._bridge_remote(dest), tag,
            rank=self._bridge_local(rank), **kw,
        )

    def _status_to_remote(self, status):
        """Translate a Status carrying a bridge source rank into the
        REMOTE-group rank MPI intercomm semantics report."""
        if status is not None and status.source >= 0:
            world = self._bridge.group.world_rank(status.source)
            status.source = self.remote_group.rank_of(world)
        return status

    def irecv(self, source: int = -1, tag: int = -1, *, rank: int):
        src = -1 if source == -1 else self._bridge_remote(source)
        req = self._bridge.irecv(src, tag, rank=self._bridge_local(rank))
        req.on_complete(lambda r: self._status_to_remote(r.status))
        return req

    def recv(self, source: int = -1, tag: int = -1, *, rank: int):
        src = -1 if source == -1 else self._bridge_remote(source)
        value, status = self._bridge.recv(
            src, tag, rank=self._bridge_local(rank)
        )
        return value, self._status_to_remote(status)

    def iprobe(self, source: int = -1, tag: int = -1, *, rank: int):
        src = -1 if source == -1 else self._bridge_remote(source)
        status = self._bridge.iprobe(
            src, tag, rank=self._bridge_local(rank)
        )
        return self._status_to_remote(status)

    def sendrecv(self, *a, **kw):
        raise MPIError(
            ErrorCode.ERR_COMM,
            "sendrecv has no inter-communicator implementation here "
            "(use isend/recv with remote-rank addressing)",
        )

    # intra-only operations are ERR_COMM on an intercommunicator (MPI:
    # scan/exscan/split require an intracomm)
    def _intra_only(self, what: str):
        raise MPIError(ErrorCode.ERR_COMM,
                       f"{what} is intra-communicator only")

    def scan(self, *a, **kw):
        self._intra_only("scan")

    def exscan(self, *a, **kw):
        self._intra_only("exscan")

    def iscan(self, *a, **kw):
        self._intra_only("iscan")

    def iexscan(self, *a, **kw):
        self._intra_only("iexscan")

    def split(self, *a, **kw):
        raise MPIError(
            ErrorCode.ERR_COMM,
            "split on intercommunicators is not supported (use merge)",
        )

    # -- inter v-variants (ragged; results land in the group
    # complementary to the contributors, MPI inter semantics) -------------
    def allgatherv(self, send_local, send_remote):
        """Local ranks receive the REMOTE group's ragged buffers
        concatenated in remote rank order (returned once). ``send_local``
        feeds the mirrored call and is validated here."""
        self._check_alive()
        self._check_counts(send_local, self.size, "allgatherv local")
        self._check_counts(send_remote, self.remote_size,
                           "allgatherv remote")
        return self._remote_comm().allgatherv(list(send_remote))

    def gatherv(self, send_remote, root: int = 0):
        """Local rank ``root`` receives the remote group's ragged
        concatenation (root-agnostic driver convention)."""
        self._check_alive()
        if not 0 <= root < self.size:
            raise MPIError(ErrorCode.ERR_ROOT,
                           f"root {root} not in local group")
        self._check_counts(send_remote, self.remote_size,
                           "gatherv remote")
        return self._remote_comm().allgatherv(list(send_remote))

    def scatterv(self, sendbuf, counts, root: int = 0):
        """Remote rank ``root`` scatters ``counts[i]`` elements to local
        rank i (ragged chunks; one tensor per local rank)."""
        self._check_alive()
        if not 0 <= root < self.remote_size:
            raise MPIError(ErrorCode.ERR_ROOT,
                           f"root {root} not in remote group")
        local = self._local_comm()
        return local.scatterv(local._buf(sendbuf).reshape(-1), counts,
                              root=0)

    def _remote_reduction(self, send_remote, op):
        from .. import ops as ops_mod

        return self._remote_comm().allreduce(send_remote,
                                             op or ops_mod.SUM)[0]

    def reduce_scatter_block(self, send_remote, op=None):
        """The remote group's contributions reduced elementwise, the
        result split in equal blocks over the local ranks (leading local
        axis, like the intra form)."""
        self._check_alive()
        self._check_counts(send_remote, self.remote_size, "rsb remote")
        red = self._remote_reduction(send_remote, op)
        n = self.size
        if red.shape[0] % n:
            raise MPIError(
                ErrorCode.ERR_COUNT,
                f"reduce_scatter_block length {red.shape[0]} not "
                f"divisible by local size {n}",
            )
        return red.reshape((n, -1) + tuple(red.shape[1:]))

    def reduce_scatter(self, send_remote, recvcounts, op=None):
        """General inter reduce_scatter: local rank i keeps the
        ``recvcounts[i]``-long segment of the remote group's reduction.
        Returns one tensor per local rank."""
        self._check_alive()
        recvcounts = [int(c) for c in recvcounts]
        if len(recvcounts) != self.size or any(c < 0 for c in recvcounts):
            raise MPIError(
                ErrorCode.ERR_COUNT,
                f"reduce_scatter needs {self.size} non-negative counts",
            )
        self._check_counts(send_remote, self.remote_size, "rs remote")
        red = self._remote_reduction(send_remote, op).reshape(-1)
        if red.shape[0] != sum(recvcounts):
            raise MPIError(
                ErrorCode.ERR_COUNT,
                f"reduce_scatter buffer length {red.shape[0]} != "
                f"counts sum {sum(recvcounts)}",
            )
        return list(torch.split(red, recvcounts))

    def alltoallv(self, send_local, counts_local, send_remote,
                  counts_remote):
        """Inter alltoallv: local rank i sends ``counts_local[i][j]``
        elements to remote rank j and receives remote rank j's chunk for
        it. Returns ``recv[i]`` per local rank in remote-rank order: pure
        ragged slicing of the remote buffers on the device."""
        self._check_alive()
        nl, nr = self.size, self.remote_size
        self._check_counts(send_local, nl, "alltoallv local")
        self._check_counts(send_remote, nr, "alltoallv remote")
        cl = torch.as_tensor(counts_local, dtype=torch.int64).reshape(nl, nr)
        cr = torch.as_tensor(counts_remote,
                             dtype=torch.int64).reshape(nr, nl)
        if bool((cl < 0).any()) or bool((cr < 0).any()):
            raise MPIError(ErrorCode.ERR_COUNT,
                           "alltoallv counts must be >= 0")
        cr = cr.tolist()
        bufs_r = [self._buf(b).reshape(-1) for b in send_remote]
        for j in range(nr):
            if bufs_r[j].shape[0] != sum(cr[j]):
                raise MPIError(
                    ErrorCode.ERR_COUNT,
                    f"alltoallv remote rank {j}: buffer has "
                    f"{bufs_r[j].shape[0]} elements, counts sum to "
                    f"{sum(cr[j])}",
                )
        # no barrier here: the result completes through its tensors, and
        # a barrier inside the blocking body would make ialltoallv
        # synchronous
        chunks = [torch.split(bufs_r[j], cr[j]) for j in range(nr)]
        return [torch.cat([chunks[j][i] for j in range(nr)])
                for i in range(nl)]

    def iallgatherv(self, send_local, send_remote):
        return self._async(self.allgatherv(send_local, send_remote))

    def igatherv(self, send_remote, root: int = 0):
        return self._async(self.gatherv(send_remote, root))

    def iscatterv(self, sendbuf, counts, root: int = 0):
        return self._async(self.scatterv(sendbuf, counts, root))

    def ireduce_scatter_block(self, send_remote, op=None):
        return self._async(self.reduce_scatter_block(send_remote, op))

    def ireduce_scatter(self, send_remote, recvcounts, op=None):
        return self._async(
            self.reduce_scatter(send_remote, recvcounts, op))

    def ialltoallv(self, send_local, counts_local, send_remote,
                   counts_remote):
        return self._async(self.alltoallv(
            send_local, counts_local, send_remote, counts_remote))

    def __repr__(self) -> str:
        return (
            f"Intercommunicator({self.name}, cid={self.cid}, "
            f"local={self.size}, remote={self.remote_size})"
        )


def intercomm_create(
    local_comm: Communicator, local_leader: int,
    peer_comm: Communicator, remote_leader: int, tag: int = 0,
) -> Tuple[Intercommunicator, Intercommunicator]:
    """``MPI_Intercomm_create``: bridge two disjoint intra-comms.

    ``local_leader``/``remote_leader`` are ranks within each comm whose
    peer link carries the group exchange in the reference (``comm.c``
    ompi_intercomm_create's leader handshake); under one controller the
    handshake is immediate but the leaders are still validated. Returns
    the mirrored pair (local side's handle first).
    """
    if not 0 <= local_leader < local_comm.size:
        raise MPIError(ErrorCode.ERR_RANK,
                       f"local_leader {local_leader} out of range")
    if not 0 <= remote_leader < peer_comm.size:
        raise MPIError(ErrorCode.ERR_RANK,
                       f"remote_leader {remote_leader} out of range")
    return Intercommunicator.create(
        local_comm.runtime, local_comm.group, peer_comm.group,
        name=f"intercomm({local_comm.name},{peer_comm.name})",
        parent=local_comm,
    )
