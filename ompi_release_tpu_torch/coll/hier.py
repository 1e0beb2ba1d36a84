"""coll/hier — collectives for communicators that SPAN controller
processes (the unified COMM_WORLD of ``tpurun -n P``; the port's
counterpart of ``ompi_release_tpu/coll/hier.py``).

Two-level compose, the ``coll/ml`` shape (``ompi/mca/coll/ml`` with
bcol/sbgp subgrouping) re-cast for the TPU runtime:

  intra  this process's members: the selected in-process collective
         over the local submesh (a shadow communicator reuses the whole
         normal coll stack — tuned selection, frozen plans, CUDA graphs
         on the card);
  inter  the process-combine step over the wire router — shm segment
         handoffs on one host, chunked DCN staging across hosts
         (``runtime/wire.py``), never a fake device copy.

Driver-mode contract on a spanning communicator: buffers carry one
leading-axis slice per LOCAL member (this process's members of the
comm, in comm-rank order) — the per-process shard of the single-
controller convention. Results keep that local leading axis;
"identical on every rank" results are replicated across it.

Reduction order: local partials use the selected local algorithm's
order; the inter step combines partials in process-index order — the
same fixed-order tree discipline the parity harness pins for the
in-process algorithms.

The inter step is SCHEDULED (:mod:`coll.hier_schedules`): recursive
doubling for small allreduce, ring/Rabenseifner reduce-scatter +
allgather for large allreduce (~2n inter bytes per process instead of
(P-1)*n), binomial trees for bcast/reduce/gather/scatter, Bruck for
small allgather/alltoall with pairwise exchange above the cutoff, and
a ``linear`` all-pairs exchange kept as the baseline (and for the
ragged v-variants, whose sizes are not globally derivable). Selection
follows the tuned precedence — ``hier_inter_algorithm`` forcing >
``hier_<coll>`` dynamic rules (PR-2 machinery; min_comm_size matches
the PROCESS count) > fixed decision constants — and every schedule
combines in a fixed, process-index-derived order identical across
ranks and runs, falling back to exact-order schedules for
non-commutative ops. A host-aware LEADER TIER (``hier_leader_tier``,
the coll/ml subgrouping shape) activates when the job spans hosts:
co-hosted processes combine/fan out over shm handoffs first and one
leader per host crosses DCN. The pvars ``hier_inter_bytes`` /
``hier_inter_msgs_sent`` / ``hier_inter_msgs_recvd`` count exactly
what crossed a process boundary so both the two-level byte reduction
and the O(P^2) -> O(log P) message-count claim are auditable.

Host staging: the wire carries host bytes. A partial on the card is
copied to the host with a blocking copy before it is sent, and every
partial rebuilt from wire bytes is moved back to the comm's device
before it reaches a combiner, so the reductions of both levels run on
the card: ``ops.op.resolve`` hands a >= 4 MiB f32/bf16 SUM to the CUDA
streaming kernel. bf16 moves through the schedules as raw 2-byte words
(numpy uint16) and is reinterpreted on the device.

Exchange overlap (``wire_overlap_exchange``, default on): every round
posts ALL its sends first — striped across peers in pipelined fragment
bursts by ``WireRouter.coll_send_all`` — then reaps receives in
ARRIVAL order (``coll_recv_any``), so one slow peer no longer blocks
the reap of peers whose data already landed, the failure mode of the
old fixed-process-order ``self._recv(p)`` loops. Per-peer FIFO order
still holds (the OOB guarantees it), so multi-message rounds keep
their member ordering.

Frozen schedules: ``coll/plan.py`` records a schedule's rounds on its
first fire and replays them later by swapping :attr:`_HierModule._xchg`
for the duration of ONE schedule run (the schedule body itself still
runs, folds on the card included); a replayed round sends through
:meth:`_HierModule._send_all_planned` (precomposed frame templates) and
reaps with the plan's timeout snapshot.

Not ported yet: the round-state table and flow ids the observability
plane reads, and the watchdog (ROADMAP item 16).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..btl.components import host_payload
from ..mca import component as mca_component
from ..mca import pvar
from ..mca import var as mca_var
from ..ops import op as _ops
from ..ops.op import Op
from ..utils import output
from ..utils.errors import ErrorCode, MPIError
from . import hier_schedules as _hs
from . import topo_schedules as _topo

_log = output.stream("coll")

_inter_bytes = pvar.counter(
    "hier_inter_bytes",
    "bytes crossing a controller-process boundary in hier collectives "
    "(SENT side)",
)
_inter_msgs_sent = pvar.counter(
    "hier_inter_msgs_sent",
    "inter-process messages SENT by hier collectives",
)
_inter_msgs_recvd = pvar.counter(
    "hier_inter_msgs_recvd",
    "inter-process messages RECEIVED by hier collectives",
)
# MPI_T-compat alias: the old ambiguous counter bumped on both sides
# (one logical message counted twice per process); it lives on as a
# read-only sum so existing tooling keeps a continuous series while
# the split pvars make the O(P^2) -> O(log P) claim auditable.
_inter_msgs = pvar.PVARS.register(
    "hier_inter_msgs", pvar.PvarClass.COUNTER,
    "inter-process messages in hier collectives (alias: sent + recvd)",
    getter=lambda: _inter_msgs_sent.read() + _inter_msgs_recvd.read(),
)
_leader_combines = pvar.counter(
    "hier_leader_combines",
    "host-leader-tier combines performed by spanning collectives",
)

def _storage(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype holding a torch dtype's bytes on the host (bf16:
    its raw 2-byte words)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty(0, dtype=dtype).numpy().dtype


class _XchgAdapter:
    """The round transport :mod:`coll.hier_schedules` drives: one call
    posts ALL of a schedule round's sends (striped/pipelined by
    ``coll_send_all`` under ``wire_overlap_exchange``), then reaps the
    round's receives in arrival order. Every byte flows through the
    module's instrumented ``_send/_send_all/_recv/_reap`` touchpoints,
    so pvar accounting is identical to the linear path's."""

    __slots__ = ("m",)

    def __init__(self, module: "_HierModule") -> None:
        self.m = module

    def exchange(self, sends: Dict[int, list],
                 recvs: Dict[int, int]) -> Dict[int, list]:
        m = self.m
        sends = {p: [m._np(a) for a in arrs]
                 for p, arrs in sends.items() if arrs}
        recvs = {p: int(c) for p, c in recvs.items() if c > 0}
        got: Dict[int, list] = {p: [] for p in recvs}
        if m._overlap():
            if sends:
                m._send_all(sends)
            if recvs:
                m._reap(dict(recvs),
                        lambda src, arr: got[src].append(arr))
            return got
        for p in sorted(sends):
            for a in sends[p]:
                m._send(p, a)
        for p in sorted(recvs):
            for _ in range(recvs[p]):
                got[p].append(m._recv(p))
        return got


class _HierModule:
    """Two-level collectives over (process, local-member) subgroups."""

    def __init__(self, comm) -> None:
        from ..comm.communicator import Communicator
        from ..comm.group import Group

        self.comm = comm
        rt = comm.runtime
        from ..runtime.wire import proc_topology

        t = proc_topology(comm)  # the one shared layout derivation
        self.router = t.router
        self.my_pidx = t.my_pidx
        self.owner = t.owner
        self.procs = t.procs
        self.members_of = t.members_of
        self.local_ranks = t.local_ranks
        self.local_n = t.local_n
        # shadow communicator over the LOCAL members: the intra level,
        # with the full normal coll stack (the bcol analogue).
        # internal=True: shadow creation happens only on processes with
        # local members, so it must not consume a global cid — that
        # counter has to stay SPMD-synchronized for wire addressing
        self.shadow = Communicator(
            rt, Group([comm.group.world_rank(i) for i in self.local_ranks]),
            name=f"{comm.name}.local", internal=True,
        )
        # the shadow lives exactly as long as its owner: freeing the
        # spanning comm frees it (no registry leak per create/free)
        comm._on_free = tuple(getattr(comm, "_on_free", ())) + (
            self.shadow.free,
        )
        #: the device holding this process's partials and results
        self.device = comm.device
        # host-aware leader tier (the coll/ml sbgp shape): group the
        # participating processes by the SAME modex-card host identity
        # the router's transport choice consults (_btl_for), so the
        # leader fan-in/fan-out stages ride shm exactly when the
        # transports do. Leader = lowest process index on the host.
        cards = self.router.cards
        self.host_of: Dict[int, str] = {
            p: str(cards[p].get("host") or f"proc-{p}")
            for p in self.procs
        }
        self.host_groups: Dict[str, List[int]] = {}
        for p in self.procs:
            self.host_groups.setdefault(self.host_of[p], []).append(p)
        self.leader_of: Dict[int, int] = {
            p: min(self.host_groups[self.host_of[p]]) for p in self.procs
        }
        self.leaders: List[int] = sorted(
            min(g) for g in self.host_groups.values())
        # uniform (d0, d1) host grid, if one exists: what the fixed
        # decision's torus pick and the topo schedules key off
        self.torus_dims = _topo.grid_dims(self.procs, self.host_of)
        # publish the topology fingerprint the tuning database selects
        # rule files by — (hosts, procs-per-host, link classes, P).
        # force=False: the WIDEST comm (the world) owns the global
        # selection; a narrower subcomm must not displace it
        from ..tuning import db as _tuning_db

        _tuning_db.set_active(
            _tuning_db.fingerprint_for(self.host_of, len(self.procs)),
            force=False)
        self._xchg = _XchgAdapter(self)
        # handle for coll/plan's frozen-schedule record/replay: the
        # plan layer swaps _xchg for the duration of ONE schedule run
        # (ops on a comm are engine-serialized, so the swap is
        # race-free) — it needs the module, which only closures hold
        comm._hier_module = self

    # -- plumbing ----------------------------------------------------------
    @property
    def peers(self) -> List[int]:
        return [p for p in self.procs if p != self.my_pidx]

    @staticmethod
    def _overlap() -> bool:
        return bool(mca_var.get("wire_overlap_exchange", True))

    # -- host/device staging ----------------------------------------------
    @staticmethod
    def _np(a) -> np.ndarray:
        """Host numpy view of a payload for the wire and the schedules:
        a tensor on the card is copied to the host with a blocking copy
        (the bytes are final before they are read); bf16 becomes its
        raw 2-byte words (uint16). A view over a host tensor's memory
        is marked read-only — the schedules copy before they write
        (as they do over the JAX package's immutable arrays), so the
        caller's buffer is never folded into in place."""
        if isinstance(a, np.ndarray):
            return a
        if isinstance(a, torch.Tensor):
            arr = host_payload(a)[0]
            if a.device.type == "cpu":
                arr = arr.view()
                arr.flags.writeable = False
            return arr
        return np.asarray(a)

    def _dev(self, a, dtype: torch.dtype) -> torch.Tensor:
        """A host payload (numpy, or a host tensor off the wire) as a
        tensor of ``dtype`` on this process's device (a blocking copy:
        the host buffer is free to reuse when this returns)."""
        if isinstance(a, torch.Tensor):
            t = a
        else:
            arr = np.ascontiguousarray(a)
            if not arr.flags.writeable:
                arr = arr.copy()
            t = torch.from_numpy(arr)
        if dtype == torch.bfloat16 and t.dtype != torch.bfloat16:
            t = t.view(torch.int16).view(torch.bfloat16)
        return t.to(self.device)

    def _ident(self, op: Op, dtype: torch.dtype) -> np.ndarray:
        """The op's identity as a 0-d host array in the schedules'
        storage dtype (bf16: its bit pattern as uint16)."""
        ident = torch.tensor(op.identity_for(dtype), dtype=dtype)
        return self._np(ident)

    def _host_op(self, op: Op, dtype: torch.dtype) -> Callable:
        """The chunked schedules' combiner on host chunks: both
        operands move to the device, fold there through the op
        framework (the CUDA SUM for >= 4 MiB f32/bf16 chunks), and the
        result comes back to the host for the next round's send."""

        def npop(a, b):
            ta, tb = self._dev(a, dtype), self._dev(b, dtype)
            fn = _ops.resolve(op, dtype, ta.numel() * ta.element_size())
            return self._np(fn(ta, tb))

        return npop

    # -- transport touchpoints ---------------------------------------------
    def _send(self, peer: int, arr) -> None:
        arr = self._np(arr)
        self.router.coll_send(self.comm, peer, arr)
        _inter_msgs_sent.add()
        _inter_bytes.add(int(arr.nbytes))

    def _recv(self, peer: int):
        out = self._np(self.router.coll_recv(self.comm, peer))
        _inter_msgs_recvd.add()
        return out

    def _send_all(self, sends: Dict[int, list]) -> None:
        """Post one round's sends to every peer, striped across
        destinations in pipelined fragment bursts (same pvar
        accounting as per-peer :meth:`_send`)."""
        self.router.coll_send_all(self.comm, sends)
        for arrs in sends.values():
            for a in arrs:
                _inter_msgs_sent.add()
                _inter_bytes.add(int(a.nbytes))

    def _send_all_planned(self, rnd, sends: Dict[int, list]) -> None:
        """Steady-state planned round send (coll/plan frozen
        schedules): channel tag, striping depth, and per-message frame
        headers were precomposed at plan time, so this path is
        memoryview slicing behind precomposed header bytes.
        Inter-process pvar accounting matches :meth:`_send_all`
        exactly."""
        self.router.coll_send_planned(self.comm, rnd, sends)
        for arrs in sends.values():
            for a in arrs:
                _inter_msgs_sent.add()
                _inter_bytes.add(int(a.nbytes))

    def _reap(self, pending: Dict[int, int],
              on_arrival: Callable[[int, np.ndarray], None],
              timeout_ms: Optional[int] = None,
              record: bool = True) -> None:
        """Reap ``pending[p]`` messages per peer in ARRIVAL order —
        a slow peer never blocks the reap of one whose data already
        landed (the posted-sends overlap the module docstring pins).
        ``timeout_ms``: explicit wait bound (frozen-plan replays pass
        their plan-time snapshot); None = the live cvar. ``record``
        is the reference's span switch (replays pass False); spans
        wait for the observability plane, so it changes nothing
        here."""
        left = sum(pending.values())
        while left:
            src, arr = self.router.coll_recv_any(self.comm, pending,
                                                 timeout_ms)
            _inter_msgs_recvd.add()
            pending[src] -= 1
            left -= 1
            on_arrival(src, self._np(arr))

    def _exchange(self, arrs_for: Dict[int, list]) -> Dict[int, list]:
        """Linear inter-process exchange: send every peer its arrays,
        then receive the same count back from each peer (all sends
        land before any recv parks — deadlock-free for the linear
        pattern). One thin shim over the exchange adapter — the SINGLE
        round-advancing code path, shared with every schedule — which
        owns the overlap/sequential split (``wire_overlap_exchange``)
        and all pvar/flow/watchdog accounting."""
        sends = {p: [self._np(a) for a in arrs_for.get(p, [])]
                 for p in self.peers}
        got = self._xchg.exchange(
            sends, {p: len(sends[p]) for p in self.peers})
        return {p: got.get(p, []) for p in self.peers}

    def _check_local_axis(self, x, what: str) -> None:
        if not hasattr(x, "shape") or x.ndim == 0 \
                or x.shape[0] != self.local_n:
            raise MPIError(
                ErrorCode.ERR_COUNT,
                f"{what} on spanning {self.comm.name}: buffers carry "
                f"one slice per LOCAL member ({self.local_n}), got "
                f"shape {getattr(x, 'shape', None)}",
            )

    def _local_partial(self, x, op: Op):
        """Reduce this process's member slices to one partial."""
        if op.is_pair_op:
            vals, idxs = x
            self._check_local_axis(vals, "pair allreduce")
            if self.local_n == 1:
                return (vals[0], idxs[0])
            out_v, out_i = self.shadow.allreduce((vals, idxs), op)
            return (out_v[0], out_i[0])
        self._check_local_axis(x, "reduce")
        if self.local_n == 1:
            return x[0]
        return self.shadow.allreduce(x, op)[0]

    # -- partial packing / combine dispatch --------------------------------
    @staticmethod
    def _pack_pair(pv: np.ndarray, pi: np.ndarray) -> np.ndarray:
        """One contiguous wire payload for a MINLOC/MAXLOC (value,
        index) partial: both sides know the shapes/dtypes from their
        own partial, so the split point ships no metadata — one
        message per peer per step instead of two (half the
        ``hier_inter_msgs_sent`` and per-message framing)."""
        pv = np.ascontiguousarray(pv)
        pi = np.ascontiguousarray(pi)
        return np.concatenate([pv.reshape(-1).view(np.uint8),
                               pi.reshape(-1).view(np.uint8)])

    @staticmethod
    def _unpack_pair(buf: np.ndarray, like_v: np.ndarray,
                     like_i: np.ndarray):
        buf = np.ascontiguousarray(np.asarray(buf)).view(np.uint8)
        nv = int(like_v.nbytes)
        v = buf[:nv].view(like_v.dtype).reshape(like_v.shape)
        i = buf[nv:].view(like_i.dtype).reshape(like_i.shape)
        return v, i

    def _pack_partial(self, partial, op: Op) -> np.ndarray:
        if op.is_pair_op:
            return self._pack_pair(self._np(partial[0]),
                                   self._np(partial[1]))
        return self._np(partial)

    def _unpack_partial(self, buf, like, op: Op):
        """A partial rebuilt from wire bytes, on this process's device
        (``like`` is read for shape/dtype only — never fetched)."""
        if op.is_pair_op:
            lv, li = like
            nv = lv.numel() * lv.element_size()
            raw = np.ascontiguousarray(self._np(buf)).view(np.uint8)
            v = self._dev(raw[:nv].view(_storage(lv.dtype)),
                          lv.dtype).reshape(lv.shape)
            i = self._dev(raw[nv:].view(_storage(li.dtype)),
                          li.dtype).reshape(li.shape)
            return (v, i)
        return self._dev(self._np(buf), like.dtype).reshape(like.shape)

    @staticmethod
    def _fold(parts: list, op: Op):
        """Left fold in list order (process-index order), each step
        through the op framework: a >= 4 MiB f32/bf16 SUM on the card
        launches the CUDA streaming kernel."""
        acc = parts[0]
        for nxt in parts[1:]:
            if op.is_pair_op:
                acc = op(acc, nxt)
            else:
                fn = _ops.resolve(op, acc.dtype,
                                  acc.numel() * acc.element_size())
                acc = fn(acc, nxt)
        return acc

    def _fold_flats(self, procs: List[int], flats: Dict[int, object],
                    partial, op: Op):
        """Fold per-process packed partials in PROCESS-INDEX order —
        the one combine sequence every exact-order schedule shares.
        ``flats`` maps pidx -> packed payload for every peer; this
        process contributes ``partial`` directly (never re-unpacked)."""
        me = self.my_pidx
        parts = [partial if p == me
                 else self._unpack_partial(flats[p], partial, op)
                 for p in procs]
        return self._fold(parts, op)

    def _leader_tier_active(self, op: Optional[Op] = None) -> bool:
        """Leader tier applies when the comm spans >1 host AND some
        host holds >1 process (else grouping is the flat set); the
        per-host fold regroups the combine order, so reductions keep
        it for commutative ops only."""
        if len(self.leaders) <= 1 or len(self.leaders) == len(self.procs):
            return False
        if op is not None and not op.commutative:
            return False
        return bool(mca_var.get("hier_leader_tier", True))

    def _pick_allreduce(self, procs: List[int], nbytes: int,
                        op: Op) -> str:
        """The inter allreduce pick for ``procs`` — one call site so
        the leader-tier stand-aside and the combine itself can never
        disagree. The topo hint describes THIS process set (the
        leader set is one-per-host, so its grid is never uniform)."""
        dims = self.torus_dims if procs is self.procs \
            else _topo.grid_dims(procs, self.host_of)
        return _hs.pick(
            "allreduce", len(procs), nbytes,
            commutative=op.commutative,
            has_identity=op.identity is not None,
            pair_op=op.is_pair_op, topo=dims,
        )

    def _combine_partials(self, partial, op: Op):
        """Inter-process combine of per-process partials; identical on
        every process (fixed, process-index-derived order per
        schedule)."""
        if len(self.procs) == 1:
            return partial
        if self._leader_tier_active(op):
            # a topology-aware pick over the FULL process set is
            # host-aware itself: the leader tier stands aside instead
            # of regrouping the torus/multiring schedule away. The
            # pack+pick feed straight into _combine_flat when it runs
            # — never computed twice on this hot path.
            packed = self._pack_partial(partial, op)
            alg = self._pick_allreduce(self.procs, int(packed.nbytes),
                                       op)
            if alg not in _topo.TOPO_ALGS:
                return self._combine_leader(partial, op)
            return self._combine_flat(self.procs, partial, op,
                                      packed=packed, alg=alg)
        return self._combine_flat(self.procs, partial, op)

    def _combine_flat(self, procs: List[int], partial, op: Op,
                      packed=None, alg: Optional[str] = None):
        """Run the selected allreduce schedule over ``procs`` (the
        whole process set, or the leader set under the leader tier).
        ``packed``/``alg`` let a caller that already packed and picked
        (the leader-tier stand-aside) hand both through."""
        P = len(procs)
        if P == 1:
            return partial
        if packed is None:
            packed = self._pack_partial(partial, op)
        if alg is None:
            alg = self._pick_allreduce(procs, int(packed.nbytes), op)
        me = self.my_pidx
        if alg in _hs.ORDER_WAIVING:
            arr = self._np(partial)
            npop = self._host_op(op, partial.dtype)
            ident = self._ident(op, partial.dtype)
            if alg == "multiring":
                out = _topo.allreduce_multiring(
                    self._xchg, procs, me, arr, npop, ident,
                    int(mca_var.get("hier_multiring_k", 4)))
            elif alg == "torus2d":
                out = _topo.allreduce_torus2d(
                    self._xchg, procs, me, arr, npop, ident,
                    self.host_of)
            else:
                fn = (_hs.allreduce_ring if alg == "ring"
                      else _hs.allreduce_rabenseifner)
                out = fn(self._xchg, procs, me, arr, npop, ident)
            return self._dev(np.asarray(out).reshape(arr.shape),
                             partial.dtype)
        if alg == "recursive_doubling":
            flats = _hs.allgather_bruck(
                self._xchg, procs, me, packed,
                [int(packed.size)] * P)
            return self._fold_flats(
                procs, dict(zip(procs, flats)), partial, op)
        # linear: the all-pairs exchange baseline (one packed message
        # per peer; pair ops no longer ship two)
        got = _hs.linear_exchange(self._xchg, procs, me, packed)
        return self._fold_flats(procs, got, partial, op)

    def _combine_leader(self, partial, op: Op):
        """Host-aware two-stage combine: co-hosted processes fold at
        their host leader (shm), leaders run the selected schedule
        across hosts (DCN), results fan back out. Fold order is fixed:
        host members in process-index order, then hosts in leader-
        index order — identical on every rank and run."""
        me = self.my_pidx
        lead = self.leader_of[me]
        if lead != me:
            _hs.round_exchange(
                self._xchg, {lead: [self._pack_partial(partial, op)]}, {})
            got = _hs.round_exchange(self._xchg, {}, {lead: 1})[lead][0]
            return self._unpack_partial(got, partial, op)
        _leader_combines.add()
        members = self.host_groups[self.host_of[me]]  # sorted (pidx)
        parts = {me: partial}
        others = [p for p in members if p != me]
        if others:
            got = _hs.round_exchange(self._xchg, {},
                                     {p: 1 for p in others})
            for p in others:
                parts[p] = self._unpack_partial(got[p][0], partial, op)
        acc = self._fold([parts[p] for p in members], op)
        total = self._combine_flat(self.leaders, acc, op)
        if others:
            tp = self._pack_partial(total, op)
            _hs.round_exchange(self._xchg, {p: [tp] for p in others}, {})
        return total

    def _bcast_local_axis(self, value, dtype=None):
        """One slice per local member (the result tensor's rows are
        independent copies: tensors are mutable)."""
        if not isinstance(value, torch.Tensor):
            value = self._dev(self._np(value), dtype)
        value = value.to(self.device)
        return value.unsqueeze(0).repeat(
            (self.local_n,) + (1,) * value.ndim)

    @classmethod
    def _cat(cls, parts: list) -> np.ndarray:
        """Concatenate per-rank slices the way all_gather+reshape does
        (0-d slices stack into a vector)."""
        parts = [cls._np(p) for p in parts]
        if parts[0].ndim == 0:
            return np.stack(parts)
        return np.concatenate(parts, axis=0)

    # -- operation table ---------------------------------------------------
    def fns(self) -> Dict[str, Callable]:
        return self._table()

    def _table(self) -> Dict[str, Callable]:
        return {
            "allreduce": self.allreduce,
            "reduce": self.reduce,
            "bcast": self.bcast,
            "allgather": self.allgather,
            "gather": self.gather,
            "scatter": self.scatter,
            "reduce_scatter_block": self.reduce_scatter_block,
            "alltoall": self.alltoall,
            "scan": self.scan,
            "exscan": self.exscan,
            "barrier": self.barrier,
            "alltoallv": self.alltoallv,
            "allgatherv": self.allgatherv,
            "gatherv": self.gatherv,
            "scatterv": self.scatterv,
            "reduce_scatter": self.reduce_scatter,
        }

    # -- reductions --------------------------------------------------------
    def allreduce(self, comm, x, op: Op):
        total = self._combine_partials(self._local_partial(x, op), op)
        if op.is_pair_op:
            tv, ti = total
            return (self._bcast_local_axis(tv),
                    self._bcast_local_axis(ti))
        return self._bcast_local_axis(total)

    def reduce(self, comm, x, op: Op, root: int):
        """Gather per-process partials to the root's owner — binomial
        tree (one packed send per non-root, ceil(log2 P) receives at
        the root) or direct linear sends — then ONE fold there in
        process-index order: bitwise-identical to the historic
        combine-everywhere path (same fold order) at a fraction of the
        messages, and exact for non-commutative ops. The result is
        masked to the root's slice (zeros elsewhere, the xla rooted-
        reduce convention)."""
        partial = self._local_partial(x, op)
        owner = self.owner[root]
        me = self.my_pidx
        P = len(self.procs)
        packed = self._pack_partial(partial, op)
        alg = _hs.pick("reduce", P, int(packed.nbytes)) if P > 1 \
            else "linear"
        flats = None
        if P == 1:
            total = partial
        elif alg == "binomial":
            flats = _hs.gather_binomial(
                self._xchg, self.procs, me, owner, packed,
                [int(packed.size)] * P)
        elif me != owner:
            _hs.round_exchange(self._xchg, {owner: [packed]}, {})
        else:
            got = _hs.round_exchange(
                self._xchg, {}, {p: 1 for p in self.procs if p != me})
            flats = [packed if p == me else got[p][0]
                     for p in self.procs]
        if flats is not None:
            total = self._fold_flats(
                self.procs, dict(zip(self.procs, flats)), partial, op)
        elif P > 1 and me != owner:
            total = None  # recv buffer undefined off-root (zeros)

        def place(t):
            out = torch.zeros((self.local_n,) + tuple(t.shape),
                              dtype=t.dtype, device=self.device)
            if total is not None and root in self.local_ranks:
                out[self.local_ranks.index(root)] = t
            return out

        if op.is_pair_op:
            like = partial if total is None else total
            return (place(like[0]), place(like[1]))
        return place(partial if total is None else total)

    def reduce_scatter_block(self, comm, x, op: Op):
        n = comm.size

        def chunked(total: np.ndarray) -> np.ndarray:
            if total.shape[0] % n:
                raise MPIError(
                    ErrorCode.ERR_COUNT,
                    f"reduce_scatter_block buffer length "
                    f"{total.shape[0]} not divisible by comm size {n}",
                )
            chunks = total.reshape((n, -1) + total.shape[1:])
            out = np.stack([chunks[r] for r in self.local_ranks])
            return out.reshape((self.local_n, -1) + total.shape[1:])

        total = self._combine_partials(self._local_partial(x, op), op)
        if op.is_pair_op:
            tv, ti = total
            return (self._dev(chunked(self._np(tv)), tv.dtype),
                    self._dev(chunked(self._np(ti)), ti.dtype))
        return self._dev(chunked(self._np(total)), total.dtype)

    # -- data movement -----------------------------------------------------
    def bcast(self, comm, x, root: int):
        owner = self.owner[root]
        me = self.my_pidx
        if owner == me:
            self._check_local_axis(x, "bcast")
            val = self._np(x[self.local_ranks.index(root)])
        else:
            val = None
        # every rank passes an x of the same per-slice shape (the
        # driver-mode SPMD convention), so the decision byte count is
        # derivable symmetrically off-root too
        slice_bytes = (int(x.numel() * x.element_size() // x.shape[0])
                       if x.ndim else 0)
        alg = _hs.pick("bcast", len(self.procs), slice_bytes,
                       topo=self.torus_dims)
        if alg == "torus2d" and len(self.procs) > 1:
            # host-aware by construction: the torus bcast subsumes the
            # leader tier's fan-out (one DCN copy per host)
            val = _topo.bcast_torus2d(self._xchg, self.procs, me,
                                      owner, val, self.host_of)
        elif alg == "binomial" and len(self.procs) > 1:
            if self._leader_tier_active():
                val = self._bcast_leader(owner, val)
            else:
                val = _hs.bcast_binomial(self._xchg, self.procs, me,
                                         owner, val)
        elif owner == me:
            self._xchg.exchange({p: [val] for p in self.peers}, {})
        else:
            val = self._xchg.exchange({}, {owner: 1})[owner][0]
        return self._bcast_local_axis(val, x.dtype)

    def _bcast_leader(self, owner: int, val):
        """Leader-tier bcast: binomial over {owner + other hosts'
        leaders} crosses DCN, then each of those fans out to its
        co-hosted processes over shm (the owner serves its own host —
        including that host's nominal leader)."""
        me = self.my_pidx
        host = self.host_of
        bset = sorted({owner} | {l for l in self.leaders
                                 if host[l] != host[owner]})
        if me in bset:
            val = _hs.bcast_binomial(self._xchg, bset, me, owner, val)
            fan = [p for p in self.host_groups[host[me]] if p != me]
            if fan:
                _hs.round_exchange(
                    self._xchg, {p: [self._np(val)] for p in fan}, {})
            return val
        src = owner if host[me] == host[owner] else self.leader_of[me]
        return np.asarray(
            _hs.round_exchange(self._xchg, {}, {src: 1})[src][0])

    def _gather_block_rows(self,
                           block: np.ndarray) -> Dict[int, np.ndarray]:
        """Every rank's slice via the selected allgather schedule over
        per-process blocks (one (local_n, chunk...) block each);
        returns {comm rank: row}."""
        me = self.my_pidx
        P = len(self.procs)
        chunk_shape = block.shape[1:]
        chunk_elems = int(np.prod(chunk_shape, dtype=np.int64)) \
            if chunk_shape else 1
        total_bytes = int(self.comm.size * chunk_elems * block.itemsize)
        alg = _hs.pick("allgather", P, total_bytes,
                       topo=self.torus_dims) if P > 1 else "linear"
        blocks: Dict[int, np.ndarray] = {}
        if P == 1 or alg == "linear":
            got = self._exchange({p: [block] for p in self.peers})
            for p in self.procs:
                blocks[p] = block if p == me else np.asarray(got[p][0])
        elif alg == "torus2d":
            parts = _topo.allgather_torus2d(self._xchg, self.procs,
                                            me, block, self.host_of)
            for i, p in enumerate(self.procs):
                blocks[p] = np.asarray(parts[i])
        elif alg == "bruck":
            counts = [len(self.members_of[p]) * chunk_elems
                      for p in self.procs]
            flats = _hs.allgather_bruck(
                self._xchg, self.procs, me,
                np.ascontiguousarray(block).reshape(-1), counts)
            for i, p in enumerate(self.procs):
                blocks[p] = np.asarray(flats[i]).reshape(
                    (len(self.members_of[p]),) + chunk_shape)
        else:  # ring: neighbor-only passes, shapes ride the wire
            parts = _hs.allgather_ring(self._xchg, self.procs, me, block)
            for i, p in enumerate(self.procs):
                blocks[p] = np.asarray(parts[i])
        rows: Dict[int, np.ndarray] = {}
        for p in self.procs:
            pblock = blocks[p]
            for pos, r in enumerate(self.members_of[p]):
                rows[r] = pblock[pos]
        return rows

    def allgather(self, comm, x):
        self._check_local_axis(x, "allgather")
        block = self._np(x)  # (local_n, chunk...)
        rows = self._gather_block_rows(block)
        full = self._cat([rows[r] for r in range(comm.size)])
        return self._bcast_local_axis(full, x.dtype)

    def gather(self, comm, x, root: int):
        self._check_local_axis(x, "gather")
        owner = self.owner[root]
        me = self.my_pidx
        P = len(self.procs)
        block = self._np(x)
        full_shape = (comm.size * block.shape[1],) + block.shape[2:] \
            if block.ndim > 1 else (comm.size,)
        chunk_shape = block.shape[1:]
        chunk_elems = int(np.prod(chunk_shape, dtype=np.int64)) \
            if chunk_shape else 1
        slice_bytes = int(chunk_elems * block.itemsize)
        alg = _hs.pick("gather", P, slice_bytes) if P > 1 else "linear"
        rows: Dict[int, np.ndarray] = {}
        if alg == "binomial" and P > 1:
            counts = [len(self.members_of[p]) * chunk_elems
                      for p in self.procs]
            flats = _hs.gather_binomial(
                self._xchg, self.procs, me, owner,
                np.ascontiguousarray(block).reshape(-1), counts)
            if flats is None:
                return torch.zeros((self.local_n,) + full_shape,
                                   dtype=x.dtype, device=self.device)
            for i, p in enumerate(self.procs):
                pblock = np.asarray(flats[i]).reshape(
                    (len(self.members_of[p]),) + chunk_shape)
                for pos, r in enumerate(self.members_of[p]):
                    rows[r] = pblock[pos]
        else:
            if owner != me:
                self._xchg.exchange({owner: [block]}, {})
                return torch.zeros((self.local_n,) + full_shape,
                                   dtype=x.dtype, device=self.device)
            for pos, r in enumerate(self.members_of[me]):
                rows[r] = block[pos]
            got = self._xchg.exchange({}, {p: 1 for p in self.peers})
            for p in self.peers:
                pblock = np.asarray(got[p][0])
                for pos, r in enumerate(self.members_of[p]):
                    rows[r] = pblock[pos]
        full = self._cat([rows[r] for r in range(comm.size)])
        out = np.zeros((self.local_n,) + full.shape, full.dtype)
        out[self.local_ranks.index(root)] = full
        return self._dev(out, x.dtype)

    def scatter(self, comm, x, root: int):
        n = comm.size
        owner = self.owner[root]
        me = self.my_pidx
        P = len(self.procs)
        # MPI reads the buffer on the root only, so non-roots cannot
        # know the message size — the schedule decision must still be
        # identical everywhere, so it is taken at bytes=0 (forcing and
        # zero-threshold rules apply; size-split rules cannot)
        alg = _hs.pick("scatter", P, 0) if P > 1 else "linear"
        chunks = None
        if owner == me:
            self._check_local_axis(x, "scatter")
            full = self._np(x[self.local_ranks.index(root)])
            if full.shape[0] % n:
                raise MPIError(
                    ErrorCode.ERR_COUNT,
                    f"scatter buffer length {full.shape[0]} not "
                    f"divisible by comm size {n}",
                )
            chunks = full.reshape((n, -1) + full.shape[1:])
        if alg == "binomial" and P > 1:
            weights = [len(self.members_of[p]) for p in self.procs]
            per_pos = meta = None
            if owner == me:
                per_pos = [np.ascontiguousarray(
                    chunks[self.members_of[p]]).reshape(-1)
                    for p in self.procs]
                meta = np.asarray(chunks.shape[1:], np.int64)
            flat, meta = _hs.scatter_binomial(self._xchg, self.procs,
                                              me, owner, per_pos,
                                              weights, meta)
            if owner == me:
                mine = chunks[self.members_of[me]]
            else:
                # the forwarded meta header carries the per-rank chunk
                # shape MPI lets only the root read
                shape = (self.local_n,) + tuple(int(s) for s in meta)
                mine = np.asarray(flat).reshape(shape)
        elif owner == me:
            self._xchg.exchange({p: [chunks[self.members_of[p]]]
                                 for p in self.peers}, {})
            mine = chunks[self.members_of[me]]
        else:
            # (local_n, chunk...)
            mine = self._xchg.exchange({}, {owner: 1})[owner][0]
        return self._dev(np.ascontiguousarray(mine), x.dtype)

    def alltoall(self, comm, x):
        self._check_local_axis(x, "alltoall")
        n = comm.size
        block = self._np(x)
        if block.shape[1] % n:
            raise MPIError(
                ErrorCode.ERR_COUNT,
                f"alltoall buffer length {block.shape[1]} not divisible "
                f"by comm size {n}",
            )
        c = block.shape[1] // n
        # chunks[a, j]: local member a's chunk destined to comm rank j
        chunks = block.reshape((self.local_n, n, c) + block.shape[2:])
        P = len(self.procs)
        me = self.my_pidx
        trail = int(np.prod(block.shape[2:], dtype=np.int64)) \
            if block.ndim > 2 else 1
        # decision unit = one rank-pair chunk's bytes (block_dsize,
        # coll_tuned_decision_fixed.c:122) — identical on every process
        alg = _hs.pick("alltoall", P, int(c * trail * block.itemsize)) \
            if P > 1 else "linear"
        recv_block: Dict[int, np.ndarray] = {}
        if P == 1:
            pass
        elif alg == "bruck":
            mlen = [len(self.members_of[p]) for p in self.procs]
            cf = c * trail
            pair_counts = [[mlen[o] * mlen[j] * cf for j in range(P)]
                           for o in range(P)]
            mine = [np.ascontiguousarray(
                chunks[:, self.members_of[p]]).reshape(-1)
                for p in self.procs]
            res = _hs.alltoall_bruck(self._xchg, self.procs, me, mine,
                                     pair_counts)
            for i, p in enumerate(self.procs):
                if p == me:
                    continue
                recv_block[p] = np.asarray(res[i]).reshape(
                    (mlen[i], self.local_n, c) + block.shape[2:])
        elif alg == "pairwise":
            payload_for = {p: np.ascontiguousarray(
                chunks[:, self.members_of[p]]) for p in self.peers}
            got = _hs.alltoall_pairwise(self._xchg, self.procs, me,
                                        payload_for)
            recv_block = {p: np.asarray(a) for p, a in got.items()}
        else:  # linear: every peer's aggregate posted at once
            got = self._exchange({p: [chunks[:, self.members_of[p]]]
                                  for p in self.peers})
            recv_block = {p: np.asarray(got[p][0]) for p in self.peers}
        out = np.empty_like(chunks)
        # local block: out[b, i] = in[a, j] for local members i->j
        for a, i in enumerate(self.local_ranks):
            for b, j in enumerate(self.local_ranks):
                out[b, i] = chunks[a, j]
        for p in self.peers:
            r = recv_block[p]  # [a, b]: p's member a -> my member b
            for a, i in enumerate(self.members_of[p]):
                for b in range(self.local_n):
                    out[b, i] = r[a, b]
        return self._dev(out.reshape(block.shape), x.dtype)

    # -- v-variant collectives (ragged; lists indexed by LOCAL member) -----
    # Spanning-comm analogue of coll/vcoll.py's driver-mode convention:
    # rank-dependent inputs/outputs are Python lists with one entry per
    # LOCAL member in comm-rank order; identical-everywhere results are
    # returned once. Counts arguments are GLOBAL (the full matrix /
    # per-rank vector on every process), matching MPI's requirement
    # that every caller supplies the complete picture.

    def _ragged_local(self, bufs, what: str) -> List[np.ndarray]:
        if len(bufs) != self.local_n:
            raise MPIError(
                ErrorCode.ERR_COUNT,
                f"{what} on spanning {self.comm.name}: pass one buffer "
                f"per LOCAL member ({self.local_n}), got {len(bufs)}",
            )
        tens = [torch.as_tensor(b) for b in bufs]
        dtypes = {t.dtype for t in tens}
        if len(dtypes) != 1:
            raise MPIError(
                ErrorCode.ERR_TYPE,
                f"{what} buffers must share one dtype, got "
                f"{sorted(map(str, dtypes))}",
            )
        if tens:
            self._vdtype = tens[0].dtype
        return [self._np(t).reshape(-1) for t in tens]

    def alltoallv(self, comm, sendbufs, sendcounts):
        """Pairwise exchange, process-aggregated
        (``coll_tuned_alltoallv.c:148`` sends rank-pairwise over the
        PML; here every process sends ONE aggregated message per peer
        process — its members' chunks for that peer's members — since
        both sides derive the sub-layout from the shared count
        matrix). ``sendcounts`` is the full (n, n) matrix; returns
        ``recv[b]`` = source-order concatenation for local member b."""
        n = comm.size
        c = np.asarray(sendcounts, dtype=np.int64)
        if c.shape != (n, n) or (c < 0).any():
            raise MPIError(
                ErrorCode.ERR_COUNT,
                f"alltoallv needs a non-negative ({n},{n}) count "
                f"matrix, got {getattr(c, 'shape', None)}",
            )
        bufs = self._ragged_local(sendbufs, "alltoallv")
        dtype = bufs[0].dtype
        offs = np.concatenate(
            [np.zeros((n, 1), np.int64), np.cumsum(c, axis=1)], axis=1
        )
        for pos, i in enumerate(self.local_ranks):
            if bufs[pos].shape[0] != int(c[i].sum()):
                raise MPIError(
                    ErrorCode.ERR_COUNT,
                    f"alltoallv rank {i}: buffer has "
                    f"{bufs[pos].shape[0]} elements, counts sum to "
                    f"{int(c[i].sum())}",
                )

        def chunk(pos: int, i: int, j: int) -> np.ndarray:
            return bufs[pos][offs[i, j]:offs[i, j] + int(c[i, j])]

        sends = {}
        for p in self.peers:
            parts = [chunk(pos, i, j)
                     for pos, i in enumerate(self.local_ranks)
                     for j in self.members_of[p]]
            sends[p] = [np.concatenate(parts) if parts
                        else np.zeros((0,), dtype)]
        got = self._exchange(sends)
        from_peer: Dict[tuple, np.ndarray] = {}
        for p in self.peers:
            msg = np.asarray(got[p][0])
            off = 0
            for i in self.members_of[p]:
                for j in self.local_ranks:
                    k = int(c[i, j])
                    from_peer[(i, j)] = msg[off:off + k]
                    off += k
            if off != msg.shape[0]:
                raise MPIError(
                    ErrorCode.ERR_TRUNCATE,
                    f"alltoallv message from process {p} has "
                    f"{msg.shape[0]} elements, count matrix implies "
                    f"{off} — mismatched sendcounts across processes?",
                )
        recv = []
        for pos, j in enumerate(self.local_ranks):
            parts = [
                chunk(self.local_ranks.index(i), i, j)
                if self.owner[i] == self.my_pidx else from_peer[(i, j)]
                for i in range(n)
            ]
            recv.append(self._dev(np.concatenate(parts) if parts
                                  else np.zeros((0,), dtype),
                                  self._vdtype))
        return recv

    def _gather_rows(self, bufs: List[np.ndarray]) -> Dict[int, np.ndarray]:
        """Every rank's ragged buffer: send each LOCAL member's buffer
        as its own message (shapes ride the wire, so no count
        pre-exchange), receive each peer's members' in comm-rank
        order (per-peer FIFO keeps member order under arrival-order
        reaping)."""
        rows: Dict[int, np.ndarray] = {
            r: bufs[pos] for pos, r in enumerate(self.local_ranks)
        }
        got = self._xchg.exchange(
            {p: list(bufs) for p in self.peers},
            {p: len(self.members_of[p]) for p in self.peers})
        for p in self.peers:
            # per-peer FIFO keeps member order under arrival reaping
            for r, arr in zip(self.members_of[p], got[p]):
                rows[r] = np.asarray(arr)
        return rows

    def allgatherv(self, comm, sendbufs):
        """Rank-order concatenation of ragged buffers; identical on
        every rank, returned once (the vcoll convention)."""
        bufs = self._ragged_local(sendbufs, "allgatherv")
        rows = self._gather_rows(bufs)
        return self._dev(
            np.concatenate([rows[r] for r in range(comm.size)]),
            self._vdtype)

    def gatherv(self, comm, sendbufs, root: int):
        """Linear gather to the root's owner process
        (``coll_base_gatherv`` linear variant): non-owner processes
        send their members' buffers and return None (MPI leaves the
        recv buffer undefined off-root); the owner returns the
        rank-order concatenation."""
        n = comm.size
        if not 0 <= root < n:
            raise MPIError(ErrorCode.ERR_ROOT, f"bad root {root}")
        bufs = self._ragged_local(sendbufs, "gatherv")
        owner = self.owner[root]
        if owner != self.my_pidx:
            self._xchg.exchange({owner: list(bufs)}, {})
            from .base import NO_RESULT

            return NO_RESULT  # recv buffer undefined off-root
        rows: Dict[int, np.ndarray] = {
            r: bufs[pos] for pos, r in enumerate(self.local_ranks)
        }
        got = self._xchg.exchange(
            {}, {p: len(self.members_of[p]) for p in self.peers})
        for p in self.peers:
            for r, arr in zip(self.members_of[p], got[p]):
                rows[r] = np.asarray(arr)
        return self._dev(np.concatenate([rows[r] for r in range(n)]),
                         self._vdtype)

    def scatterv(self, comm, sendbuf, counts, root: int):
        """Root's owner splits ``sendbuf`` by ``counts`` and ships each
        remote rank's chunk to its owner; returns one array per LOCAL
        member. ``sendbuf`` is read only on the owner process."""
        n = comm.size
        if not 0 <= root < n:
            raise MPIError(ErrorCode.ERR_ROOT, f"bad root {root}")
        counts = [int(k) for k in counts]
        if len(counts) != n or any(k < 0 for k in counts):
            raise MPIError(
                ErrorCode.ERR_COUNT,
                f"scatterv needs {n} non-negative counts, got {counts}",
            )
        owner = self.owner[root]
        dtype = torch.as_tensor(sendbuf).dtype
        if owner != self.my_pidx:
            got = self._xchg.exchange({}, {owner: self.local_n})
            return [self._dev(a, dtype) for a in got[owner]]
        buf = self._np(torch.as_tensor(sendbuf)).reshape(-1)
        if buf.shape[0] != sum(counts):
            raise MPIError(
                ErrorCode.ERR_COUNT,
                f"scatterv root buffer has {buf.shape[0]} elements, "
                f"counts sum to {sum(counts)}",
            )
        offs = np.concatenate([[0], np.cumsum(counts)])
        chunks = [buf[offs[j]:offs[j] + counts[j]] for j in range(n)]
        self._xchg.exchange({p: [chunks[j] for j in self.members_of[p]]
                             for p in self.peers}, {})
        return [self._dev(chunks[j], dtype) for j in self.local_ranks]

    def reduce_scatter(self, comm, x, recvcounts, op: Op):
        """General MPI_Reduce_scatter: combine (local partial, then
        process-index-order inter combine — the allreduce discipline),
        each rank keeps its ``recvcounts[i]``-length segment. ``x`` is
        (local_n, total); returns one array per LOCAL member."""
        n = comm.size
        recvcounts = [int(k) for k in recvcounts]
        if len(recvcounts) != n or any(k < 0 for k in recvcounts):
            raise MPIError(
                ErrorCode.ERR_COUNT,
                f"reduce_scatter needs {n} non-negative counts",
            )
        total = sum(recvcounts)
        if op.is_pair_op:
            vals, idxs = x
            self._check_local_axis(vals, "reduce_scatter")
            if vals.reshape(self.local_n, -1).shape[1] != total:
                raise MPIError(
                    ErrorCode.ERR_COUNT,
                    f"reduce_scatter needs values shaped "
                    f"({self.local_n}, {total}), got {vals.shape}",
                )
            tv, ti = self._combine_partials(
                self._local_partial((vals, idxs), op), op
            )
            tv, ti = tv.reshape(-1), ti.reshape(-1)
            offs = np.concatenate([[0], np.cumsum(recvcounts)])
            return [
                (tv[offs[r]:offs[r] + recvcounts[r]].clone(),
                 ti[offs[r]:offs[r] + recvcounts[r]].clone())
                for r in self.local_ranks
            ]
        x = torch.as_tensor(x).to(self.device)
        if x.shape[0] != self.local_n \
                or x.reshape(self.local_n, -1).shape[1] != total:
            raise MPIError(
                ErrorCode.ERR_COUNT,
                f"reduce_scatter needs x shaped ({self.local_n}, "
                f"{total}), got {x.shape}",
            )
        x = x.reshape(self.local_n, total)
        red = self._combine_partials(self._local_partial(x, op), op)
        offs = np.concatenate([[0], np.cumsum(recvcounts)])
        return [red[offs[r]:offs[r] + recvcounts[r]].clone()
                for r in self.local_ranks]

    # -- prefix scans ------------------------------------------------------
    def _full_rows(self, x) -> Dict[int, np.ndarray]:
        """Every rank's slice, via the selected allgather schedule."""
        return self._gather_block_rows(self._np(x))

    def _scan_impl(self, comm, x, op: Op, exclusive: bool):
        if op.is_pair_op:
            # MINLOC/MAXLOC scans: fold the gathered (value, index)
            # rows with the pair combiner in rank order; the rank-0
            # exscan slice is zeros (MPI leaves it undefined)
            vals, idxs = x
            self._check_local_axis(vals, "scan")
            vrows = self._full_rows(vals)
            irows = self._full_rows(idxs)
            outv, outi = [], []
            for r in self.local_ranks:
                end = r if exclusive else r + 1
                if end == 0:
                    outv.append(np.zeros_like(vrows[0]))
                    outi.append(np.zeros_like(irows[0]))
                    continue
                acc = (self._dev(vrows[0], vals.dtype),
                       self._dev(irows[0], idxs.dtype))
                for j in range(1, end):
                    acc = op(acc, (self._dev(vrows[j], vals.dtype),
                                   self._dev(irows[j], idxs.dtype)))
                outv.append(self._np(acc[0]))
                outi.append(self._np(acc[1]))
            return (self._dev(np.stack(outv), vals.dtype),
                    self._dev(np.stack(outi), idxs.dtype))
        self._check_local_axis(x, "scan")
        rows = self._full_rows(x)
        out = []
        for r in self.local_ranks:
            if exclusive:
                if r == 0:
                    out.append(np.zeros_like(rows[0]))
                    continue
                end = r
            else:
                end = r + 1
            acc = self._fold([self._dev(rows[j], x.dtype)
                              for j in range(end)], op)
            out.append(self._np(acc))
        return self._dev(np.stack(out), x.dtype)

    def scan(self, comm, x, op: Op):
        return self._scan_impl(comm, x, op, exclusive=False)

    def exscan(self, comm, x, op: Op):
        return self._scan_impl(comm, x, op, exclusive=True)

    # -- synchronization ---------------------------------------------------
    def barrier(self, comm):
        if self.local_n > 1:
            self.shadow.barrier()
        self.router.proc_barrier(self.comm, self.procs)


class HierCollComponent(mca_component.Component):
    """Claims exactly the communicators no in-process component can
    serve: those spanning controller processes."""

    NAME = "hier"
    PRIORITY = 150

    def query(self, ctx=None):
        if ctx is None:
            return (self.priority, self)
        if not getattr(ctx, "spans_processes", False):
            return None
        if getattr(ctx.runtime, "wire", None) is None:
            return None  # no router: nothing can serve this comm
        return (self.priority, _HierModule(ctx))
