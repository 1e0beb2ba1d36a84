"""btl framework — the byte-transfer-layer analogue, device-native
(counterpart of ``ompi_release_tpu/btl/base.py``).

The reference's data-plane pluggability lives in the BTL interface
(``ompi/mca/btl/btl.h:795-838``): each module exposes transfer entry
points plus *attributes* — eager/rndv/max-send sizes (``btl.h:799-804``)
and a latency/bandwidth ranking (``btl.h:806-807``) — and the BML "r2"
multiplexer sorts each peer's eligible BTLs into ``btl_eager`` /
``btl_send`` / ``btl_rdma`` lists and stripes large transfers across
rails (``ompi/mca/bml/bml.h:71,229``).

Device-native reinterpretation: a "transfer" is a device-to-device
tensor move. The wire protocols (sockets, verbs QPs, shared-memory
FIFOs) collapse into *which path the copy takes* — a copy on the card
(the in-card pair: virtual ranks share one H100), a copy between two
cards of one process, or an explicit host-memory staging bounce — so
a component here is a (reachability predicate,
move function, size/ranking attributes) triple, and the BML's job —
pick the transfer path per peer and per message size, stripe segments
across rails — survives unchanged.

Module attributes (all MCA-variable overridable, per component):
  eager_limit    bytes moved in one shot at send time (btl.h:799)
  max_send_size  single-segment ceiling; beyond it transfers are
                 segmented/pipelined (btl.h:802 rdma pipeline)
  latency        relative cost to start a transfer (lower = better)
  bandwidth      MB/s ranking input for rail striping (higher = better)
  exclusivity    peers reachable by a higher-exclusivity btl drop
                 lower ones from their lists (btl.h:797 analogue)
"""

from __future__ import annotations

import math
import time as _time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import obs as _obs
from ..mca import component as mca_component
from ..mca import pvar
from ..mca import var as mca_var
from ..utils import output
from ..utils.errors import ErrorCode, MPIError

_log = output.stream("btl")

BTL_FRAMEWORK = mca_component.framework(
    "btl", "byte/buffer transfer layer (ompi/mca/btl analogue)"
)

_striped_moves = pvar.counter(
    "bml_striped_moves", "pipelined transfers striped across >1 rail"
)


class BtlModule:
    """One transfer path instance (the ``mca_btl_base_module_t``).

    Subclasses implement :meth:`reachable` (can this module move
    between the two endpoints?) and :meth:`move_segment` (one
    contiguous transfer). Size/ranking attributes are read through the
    MCA variable system so every one is user-tunable exactly like the
    reference's ``btl_<name>_<attr>`` parameters.
    """

    #: class defaults; instances read the MCA variables registered by
    #: the owning component (see Component.register_vars)
    NAME = "base"
    EAGER_LIMIT = 64 * 1024
    MAX_SEND_SIZE = 16 * 1024 * 1024
    LATENCY = 50
    BANDWIDTH = 1000
    EXCLUSIVITY = 0
    #: False for out-of-band transports (shm handoff) whose transfer
    #: entry points are not move_segment — the BML keeps them out of
    #: its in-band move lists so selection cannot route a device move
    #: onto a module that cannot perform one
    SUPPORTS_MOVE = True

    def _var(self, attr: str, default: int) -> int:
        return int(mca_var.get(f"btl_{self.NAME}_{attr}", default))

    @property
    def eager_limit(self) -> int:
        return self._var("eager_limit", self.EAGER_LIMIT)

    @property
    def max_send_size(self) -> int:
        return self._var("max_send_size", self.MAX_SEND_SIZE)

    @property
    def latency(self) -> int:
        return self._var("latency", self.LATENCY)

    @property
    def bandwidth(self) -> int:
        return self._var("bandwidth", self.BANDWIDTH)

    @property
    def exclusivity(self) -> int:
        return self._var("exclusivity", self.EXCLUSIVITY)

    # -- interface ---------------------------------------------------------
    def reachable(self, src_ep, dst_ep) -> bool:
        """Can this module carry src_ep -> dst_ep? (add_procs analogue)"""
        raise NotImplementedError

    def move_segment(self, data, dst_device):
        """Move one contiguous array to ``dst_device``; returns the
        moved tensor (the copy is queued on the current stream)."""
        raise NotImplementedError

    # -- accounting --------------------------------------------------------
    def _cached_counter(self, attr: str, name: str, doc: str):
        """Lazily-registered, instance-cached pvar (hot paths call
        .add() per chunk — no registry lookup per call)."""
        c = getattr(self, attr, None)
        if c is None:
            c = pvar.counter(name, doc)
            setattr(self, attr, c)
        return c

    @property
    def bytes_pvar(self):
        return self._cached_counter(
            "_bytes_pvar", f"btl_{self.NAME}_bytes",
            f"bytes moved through the {self.NAME} btl",
        )

    @property
    def move_hist(self):
        """Per-BTL log2 size distribution (obs plane), lazily cached
        like the byte counter."""
        h = getattr(self, "_move_hist", None)
        if h is None:
            h = pvar.histogram(
                f"btl_{self.NAME}_move_bytes",
                f"per-move payload bytes through the {self.NAME} btl, "
                "log2 buckets",
            )
            self._move_hist = h
        return h

    def move(self, data, dst_device):
        nbytes = int(data.numel() * data.element_size())
        self.bytes_pvar.add(nbytes)
        if not _obs.enabled:
            return self.move_segment(data, dst_device)
        # dispatch time: the copy is queued on the stream, not awaited
        t0 = _time.perf_counter()
        out = self.move_segment(data, dst_device)
        self.move_hist.observe(nbytes)
        _obs.record(f"move[{self.NAME}]", "btl", t0,
                    _time.perf_counter() - t0, nbytes=nbytes)
        return out


def register_module_vars(mod_cls) -> None:
    """Register the standard per-module attribute variables."""
    n = mod_cls.NAME
    for attr, default, doc in (
        ("eager_limit", mod_cls.EAGER_LIMIT,
         "bytes moved in one eager shot (btl.h:799)"),
        ("max_send_size", mod_cls.MAX_SEND_SIZE,
         "single-segment ceiling; larger transfers pipeline (btl.h:802)"),
        ("latency", mod_cls.LATENCY,
         "relative transfer-start cost, lower preferred (btl.h:806)"),
        ("bandwidth", mod_cls.BANDWIDTH,
         "MB/s ranking input for rail striping (btl.h:807)"),
        ("exclusivity", mod_cls.EXCLUSIVITY,
         "peers reachable at higher exclusivity drop lower btls"),
    ):
        mca_var.register(
            f"btl_{n}_{attr}", "size" if "limit" in attr or "size" in attr
            else "int", default, f"{n}: {doc}",
        )


class BmlEndpoint:
    """Per-peer transfer plan — the ``mca_bml_base_endpoint_t`` (bml.h:71).

    Holds this (src, dst) pair's eligible modules sorted into the three
    reference lists:
      btl_eager  lowest latency first — small messages
      btl_send   lowest latency first — mid-size single-segment
      btl_rdma   highest bandwidth first — pipelined rails, striped
    """

    __slots__ = ("src_ep", "dst_ep", "dst_device", "btl_eager", "btl_send",
                 "btl_rdma")

    def __init__(self, src_ep, dst_ep, dst_device,
                 modules: Sequence[BtlModule]) -> None:
        self.src_ep = src_ep
        self.dst_ep = dst_ep
        self.dst_device = dst_device
        reach = [m for m in modules if m.reachable(src_ep, dst_ep)]
        # out-of-band transports (shm handoff) are reachable but have
        # no in-band move entry point: the move lists hold movers only
        movers = [m for m in reach if m.SUPPORTS_MOVE]
        if not movers:
            raise MPIError(
                ErrorCode.ERR_UNREACH,
                f"no btl reaches rank {dst_ep.rank} from {src_ep.rank}",
            )
        # exclusivity: keep only the highest tier (btl.h:797 — e.g. the
        # loopback btl owns self-sends outright, as btl/self does)
        top = max(m.exclusivity for m in movers)
        tier = [m for m in movers if m.exclusivity == top]
        self.btl_eager = sorted(tier, key=lambda m: (m.latency, m.NAME))
        self.btl_send = list(self.btl_eager)
        self.btl_rdma = sorted(
            tier, key=lambda m: (-m.bandwidth, m.NAME)
        )

    # -- size-driven path selection (ob1's protocol switch points) ---------
    @property
    def eager_limit(self) -> int:
        return self.btl_eager[0].eager_limit

    @property
    def max_send_size(self) -> int:
        return self.btl_send[0].max_send_size

    def move(self, data, *, max_send: Optional[int] = None,
             on_pipeline=None):
        """Move ``data`` to this peer, choosing path + segmentation by
        size exactly as ob1 chooses start_copy/start_prepare/start_rdma
        (``pml_ob1_sendreq.c:480,610,667``). ``max_send`` overrides the
        btl's segment ceiling (the pml pipeline-size knob);
        ``on_pipeline`` is invoked iff the transfer actually segments
        (so callers' counters match reality)."""
        import torch

        nbytes = int(data.numel() * data.element_size())
        seg = max_send or self.btl_rdma[0].max_send_size
        if data.ndim == 0 or nbytes <= seg:
            btl = (self.btl_eager if nbytes <= self.eager_limit
                   else self.btl_send)[0]
            return btl.move(data, self.dst_device)
        # pipelined: stripe max_send-sized segments across the rdma
        # rails, share per rail proportional to bandwidth (bml r2
        # round-robin weighted striping, bml.h:229)
        if on_pipeline is not None:
            on_pipeline()
        flat = data.reshape(-1)
        seg_elems = max(1, seg // data.element_size())
        nseg = math.ceil(flat.shape[0] / seg_elems)
        rails = self._rail_schedule(nseg)
        if len(set(rails)) > 1:
            _striped_moves.add()
        out = []
        for i in range(nseg):
            chunk = flat[i * seg_elems:(i + 1) * seg_elems]
            out.append(self.btl_rdma[rails[i]].move(chunk, self.dst_device))
        return torch.cat(out).reshape(data.shape)

    def _rail_schedule(self, nseg: int) -> List[int]:
        """Assign each segment a rail index, weighted by bandwidth."""
        # clamp: bandwidth is a user-settable var; a 0 would starve the
        # rail and stall the scheduler below
        bws = [max(1, m.bandwidth) for m in self.btl_rdma]
        total = sum(bws)
        # largest-remainder apportionment, then interleave
        counts = [nseg * b // total for b in bws]
        rema = sorted(
            range(len(bws)),
            key=lambda i: -(nseg * bws[i] - counts[i] * total),
        )
        for i in rema[: nseg - sum(counts)]:
            counts[i] += 1
        sched: List[int] = []
        pending = list(counts)
        while len(sched) < nseg:
            for r in range(len(bws)):
                if pending[r] > 0:
                    sched.append(r)
                    pending[r] -= 1
        return sched

    def describe(self) -> Dict[str, Any]:
        return {
            "dst": self.dst_ep.rank,
            "eager": [m.NAME for m in self.btl_eager],
            "send": [m.NAME for m in self.btl_send],
            "rdma": [m.NAME for m in self.btl_rdma],
            "eager_limit": self.eager_limit,
            "max_send_size": self.max_send_size,
        }


class BmlR2:
    """Per-communicator BTL multiplexer (the bml/r2 component).

    Opens the btl framework, queries every component against the
    communicator (add_procs analogue) and builds per-peer endpoints
    lazily.
    """

    def __init__(self, comm) -> None:
        self.comm = comm
        # comm rank -> LOCAL device; under a unified multi-controller
        # world only this process's members have devices here — cross-
        # process pairs never get a BML endpoint (the wire pml routes
        # them through the shm/dcn staged transports instead)
        flat = list(comm.submesh.devices.reshape(-1))
        local = getattr(comm, "local_comm_ranks", None)
        if local is None:
            local = range(comm.size)
        self._devices = {r: flat[i] for i, r in enumerate(local)}
        eps = {e.rank: e for e in comm.runtime.endpoints}
        self._eps = [
            eps[comm.group.world_rank(i)] for i in range(comm.size)
        ]
        self._modules: List[BtlModule] = [
            m for _, _, m in BTL_FRAMEWORK.available(comm)
        ]
        if not self._modules:
            raise MPIError(
                ErrorCode.ERR_NOT_AVAILABLE, "no btl component available"
            )
        self._endpoints: Dict[Tuple[int, int], BmlEndpoint] = {}
        _log.verbose(
            2,
            f"{comm.name}: btl modules "
            f"{[m.NAME for m in self._modules]}",
        )

    def endpoint(self, src_rank: int, dst_rank: int) -> BmlEndpoint:
        key = (src_rank, dst_rank)
        ep = self._endpoints.get(key)
        if ep is None:
            dst_device = self._devices.get(dst_rank)
            if dst_device is None:
                raise MPIError(
                    ErrorCode.ERR_UNREACH,
                    f"rank {dst_rank} belongs to another controller "
                    "process — in-band BML moves cannot reach it; "
                    "cross-process pairs route through the wire pml",
                )
            ep = BmlEndpoint(
                self._eps[src_rank], self._eps[dst_rank],
                dst_device, self._modules,
            )
            self._endpoints[key] = ep
        return ep
