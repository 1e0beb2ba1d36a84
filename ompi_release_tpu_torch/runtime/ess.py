"""ESS — environment-specific bootstrap (``orte/mca/ess`` analogue).

Counterpart of ``ompi_release_tpu/runtime/ess.py``:

  - ``singleton``: one controller process owning the devices it names;
  - ``tpurun``: a worker process launched by ``tools/tpurun`` (the
    ``ess/env`` analogue) — the coordinator wire-up runs inside
    bring-up and the worker joins the unified COMM_WORLD.

The device set is torch devices: every visible CUDA card by default, or
the one device the caller asked for (``init(device=...)``). A CUDA
request on a machine without CUDA raises — the runtime never carries on
silently on the host. Not ported yet: ``distributed`` (the
``jax.distributed`` bootstrap of the JAX package has no counterpart
until the native datapath slice).
"""

from __future__ import annotations

import os
import socket
from typing import List, Optional

import torch

from ..mca import component as mca_component
from ..mca import var as mca_var
from ..utils import output
from ..utils.errors import ErrorCode, MPIError

_log = output.stream("ess")


def read_stdin_secret(stream) -> str:
    """One line of ``stream`` as the job secret (OMPITPU_SECRET_STDIN
    rsh handoff). An empty line / EOF means the launcher died or the
    pipe was misplumbed — that MUST fail the launch loudly: silently
    proceeding would disable auth on this endpoint and surface later
    as an opaque OOB connect failure."""
    line = stream.readline().strip()
    if not line:
        raise MPIError(
            ErrorCode.ERR_OTHER,
            "OMPITPU_SECRET_STDIN=1 but no job secret arrived on stdin "
            "(launcher died or stdin not forwarded)",
        )
    return line


def discover_devices(device=None) -> List[torch.device]:
    """The device set a singleton controller owns: ``device`` when
    given, else every CUDA card (``cuda:0`` first)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MPIError(
                ErrorCode.ERR_NOT_AVAILABLE,
                f"no CUDA device: the runtime runs on the card ({dev}) "
                "unless the caller asks for the host with device='cpu'",
            )
        if dev.index is None:
            if device is None:
                return [torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
            dev = torch.device("cuda", 0)
        if dev.index >= torch.cuda.device_count():
            raise MPIError(ErrorCode.ERR_NOT_AVAILABLE,
                           f"{dev} not present "
                           f"({torch.cuda.device_count()} CUDA devices)")
    return [dev]


class SingletonEss(mca_component.Component):
    """Single-controller bootstrap: the requested devices, process 0."""

    NAME = "singleton"
    PRIORITY = 10

    def bootstrap(self, device: Optional[object] = None):
        devices = discover_devices(device)
        return {
            "process_index": 0,
            "process_count": 1,
            "devices": devices,
            "local_devices": devices,
        }


class TpurunEss(mca_component.Component):
    """Bootstrap for processes launched by ``tpurun`` (the ess/env
    analogue: mpirun-launched procs detect the daemon's env vars,
    ``orte/mca/ess/env/ess_env_module.c:87``).

    Runs the FULL coordinator wire-up inside bring-up: JOIN + modex
    through the HNP, binomial tree link setup, a direct OOB link to
    every peer worker, the init barrier, and the heartbeat thread —
    so ``Runtime.init`` under tpurun flows through the OOB exactly like
    ``ompi_mpi_init.c:630-642,811`` flows through the daemon tree.

    The modex card advertises ``local_device_count`` — the number of
    world ranks this process owns (``runtime_virtual_ranks`` when set,
    else one per device) — and ``platform`` (``gpu`` or ``cpu``).
    """

    NAME = "tpurun"
    PRIORITY = 60

    def register_vars(self) -> None:
        mca_var.register(
            "ess_tpurun_heartbeat_interval", "float", 0.5,
            "Seconds between worker heartbeats to the HNP "
            "(sensor_heartbeat.c:61 analogue)",
        )

    def query(self, ctx=None):
        if not os.environ.get("OMPITPU_HNP"):
            return None
        return (self.priority, self)

    def bootstrap(self, device: Optional[object] = None):
        import sys

        from . import coordinator as coord
        from . import mesh as mesh_mod

        devices = discover_devices(device)
        host, port = os.environ["OMPITPU_HNP"].rsplit(":", 1)
        node_id = int(os.environ["OMPITPU_NODE_ID"])
        num_workers = int(os.environ["OMPITPU_NUM_NODES"])
        if (os.environ.get("OMPITPU_SECRET_STDIN") == "1"
                and not os.environ.get("OMPITPU_JOB_SECRET")):
            # rsh launches ship the job secret on stdin (a command-line
            # env assignment would be world-readable via /proc); it
            # must land before the first endpoint is created
            os.environ["OMPITPU_JOB_SECRET"] = read_stdin_secret(sys.stdin)
        agent = coord.WorkerAgent(node_id, host, int(port))
        card = {
            "node_id": node_id,
            "pid": os.getpid(),
            # shm-reachability identity. OMPITPU_HOST_ID overrides the
            # UTS hostname: two containers can SHARE a hostname while
            # having separate /dev/shm, and test rigs use it to drive
            # the DCN staging path on one machine
            "host": os.environ.get("OMPITPU_HOST_ID")
                    or socket.gethostname(),
            "local_device_count": len(mesh_mod.rank_devices(devices)),
            "platform": "gpu" if devices[0].type == "cuda" else "cpu",
        }
        # nativewire capability advertisement (ring token/geometry):
        # empty when the native datapath is absent or disabled, and the
        # card then stays portable-only
        from ..btl import nativewire as _nativewire

        card.update(_nativewire.modex_entry())
        cards = agent.run_modex(card)  # launcher mode: workers only
        agent.setup_tree(num_workers + 1, cards)
        # FULL wire-up (superset of the tree edges): connect to every
        # lower-id peer so ANY worker pair holds a live OOB link — the
        # data plane the unified COMM_WORLD's cross-process transports
        # (runtime/wire.py) ride. The HIGHER id dials; a dead peer
        # address fails the launch loudly.
        parent = coord.binomial_parent(node_id)
        for nid in range(1, node_id):
            if nid == parent:
                continue  # tree link already exists
            peer = cards[nid - 1]
            agent.ep.connect(nid, peer["oob_host"], int(peer["oob_port"]))
        agent.barrier()  # every tree+wire edge live; init gate
        agent.start_heartbeats(
            float(mca_var.get("ess_tpurun_heartbeat_interval", 0.5)))
        _log.verbose(
            1, f"tpurun bootstrap: node {node_id}/{num_workers} wired")
        return {
            "process_index": node_id - 1,
            "process_count": num_workers,
            "devices": devices,
            "local_devices": devices,
            "agent": agent,
            "peer_cards": cards,
        }


ESS_FRAMEWORK = mca_component.framework(
    "ess", "environment-specific bootstrap (orte/mca/ess analogue)"
)
ESS_FRAMEWORK.register(SingletonEss())
ESS_FRAMEWORK.register(TpurunEss())
