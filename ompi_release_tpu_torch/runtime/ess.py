"""ESS — environment-specific bootstrap (``orte/mca/ess`` analogue).

Counterpart of ``ompi_release_tpu/runtime/ess.py``:

  - ``singleton``: one controller process owning the devices it names;
  - ``distributed``: processes started by hand with a coordinator
    address, their id and their count (``OMPITPU_COORDINATOR``,
    ``OMPITPU_PROCESS_ID``, ``OMPITPU_NUM_PROCESSES``); process 0 hosts
    the coordinator service in-process and every process joins it as
    an agent, as under the launcher;
  - ``tpurun``: a worker process launched by ``tools/tpurun`` (the
    ``ess/env`` analogue) — the coordinator wire-up runs inside
    bring-up and the worker joins the unified COMM_WORLD.

The device set is torch devices: every visible CUDA card by default, or
the one device the caller asked for (``init(device=...)``). A CUDA
request on a machine without CUDA raises — the runtime never carries on
silently on the host.
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


def wire_up(node_id: int, num_workers: int, hnp_host: str, hnp_port: int,
            device: Optional[object] = None, *,
            dial_timeout_s: float = 0.0) -> dict:
    """The coordinator wire-up of a launcher-style process (``tpurun``
    and ``distributed``): JOIN + modex through the HNP at
    ``hnp_host:hnp_port`` as node ``node_id`` of ``num_workers``
    workers, binomial tree link setup, a direct OOB link to every peer
    worker, the init barrier and the heartbeat thread. Returns the
    bootstrap dict; ``process_index`` is ``node_id - 1``.

    ``dial_timeout_s`` > 0 retries the first dial of the HNP until that
    deadline (a hand-started process may come up before the one that
    hosts the HNP listens)."""
    from . import coordinator as coord
    from . import mesh as mesh_mod

    devices = discover_devices(device)
    agent = coord.WorkerAgent(node_id, hnp_host, hnp_port,
                              dial_timeout_s=dial_timeout_s)
    try:
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
            # a respawned worker's incarnation (tpurun exports it into
            # replacements only): its nativewire rings take names of
            # their own
            "incarnation": int(os.environ.get("OMPITPU_INCARNATION",
                                              "0") or 0),
        }
        # nativewire capability advertisement (ring token/geometry):
        # empty when the native datapath is absent or disabled, and the
        # card then stays portable-only
        from ..btl import nativewire as _nativewire

        card.update(_nativewire.modex_entry())
        cards = agent.run_modex(card)  # launcher mode: workers only
        if len(cards) != num_workers:
            raise MPIError(
                ErrorCode.ERR_OTHER,
                f"modex returned {len(cards)} worker cards, this process "
                f"was told the job has {num_workers} processes")
        agent.setup_tree(num_workers + 1, cards)
        # FULL wire-up (superset of the tree edges): connect to every
        # lower-id peer so ANY worker pair holds a live OOB link — the
        # data plane the unified COMM_WORLD's cross-process transports
        # (runtime/wire.py) ride. The HIGHER id dials.
        parent = coord.binomial_parent(node_id)
        recovery = os.environ.get("OMPITPU_RECOVERY") == "1"
        for nid in range(1, node_id):
            if nid == parent:
                continue  # tree link already exists
            peer = cards[nid - 1]
            try:
                agent.ep.connect(nid, peer["oob_host"],
                                 int(peer["oob_port"]))
            except MPIError:
                if not recovery:
                    # default policy: a dead peer address (typo'd
                    # hostfile, firewalled port) must fail the launch
                    # loudly, not surface later as a missing link
                    raise
                # resilient policy: the peer may have finished or be
                # mid-restart — the wire router raises a clear
                # ERR_UNREACH if this link is ever actually used
                _log.verbose(
                    1, f"wire-up: peer {nid} unreachable at "
                       f"{peer['oob_host']}:{peer['oob_port']} "
                       "(finished or restarting); continuing without "
                       "the link")
        agent.barrier()  # every tree+wire edge live; init gate
    except BaseException:
        agent.close()
        raise
    agent.start_heartbeats(
        float(mca_var.get("ess_tpurun_heartbeat_interval", 0.5)))
    _log.verbose(1, f"wire-up: node {node_id}/{num_workers} wired")
    return {
        "process_index": node_id - 1,
        "process_count": num_workers,
        "devices": devices,
        "local_devices": devices,
        "agent": agent,
        "peer_cards": cards,
    }


#: heartbeat intervals a silent process may miss before the hosted HNP
#: promotes it failed (a launcher-less job has no waitpid to see a
#: crash sooner, and a false promotion fails the survivors' waits)
HOSTED_MISS_LIMIT = 20


class HostedHnp:
    """The launcher's coordinator service, hosted by process 0 of a job
    without a launcher (``distributed``): an ``HnpCoordinator`` for
    ``num_processes`` agents at nodes 1..n and one service thread that
    runs what ``tools/tpurun.py``'s ``serve`` runs, minus process
    management — the modex and init barrier, the heartbeat monitor
    (its failure hook only logs: the monitor itself promotes the node
    and pushes the ULFM notice, and there is no process to kill or
    respawn), the name service, the clock, series and ft responders,
    and the FIN collection. No rejoin or migrate service (nothing
    respawns or moves a process) and no session contact file."""

    def __init__(self, num_processes: int, port: int, bind_addr: str,
                 interval_s: float, *, timeout_s: float = 30.0) -> None:
        import threading

        from . import coordinator as coord

        try:
            self.hnp = coord.HnpCoordinator(num_processes + 1, port,
                                            bind_addr)
        except MPIError as e:
            raise MPIError(
                ErrorCode.ERR_PORT,
                f"distributed ESS: process 0 cannot host the coordinator "
                f"at {bind_addr}:{port} (port taken?): {e}") from None
        self.n = num_processes
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self._stop = threading.Event()
        self._fin: set = set()  # the service thread's own
        self.error: Optional[BaseException] = None
        #: set when this process dies of an uncaught exception: its
        #: exit then stops hosting at once (what the launcher's abort
        #: policy does) instead of waiting for peers that may be
        #: waiting for it
        self.abandoned = False
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="hosted-hnp")
        self._thread.start()

    def abandon_on_uncaught_exception(self) -> None:
        """Chain ``sys.excepthook``: an uncaught exception in this
        process marks the service abandoned before the exit's
        finalize runs."""
        import sys

        prev = sys.excepthook

        def hook(tp, val, tb):
            self.abandoned = True
            prev(tp, val, tb)

        sys.excepthook = hook

    def _on_failure(self, nid: int) -> None:
        _log.verbose(0, f"hosted HNP: process {nid - 1} heartbeat lost; "
                        "promoted failed")

    def _done(self) -> set:
        with self.hnp._hb_lock:
            return self._fin | self.hnp._failed

    def _serve(self) -> None:
        ms = int(self.timeout_s * 1000)
        try:
            self.hnp.run_modex(None, timeout_ms=ms)
            self.hnp.barrier(timeout_ms=ms)
        except Exception as e:
            self.error = e
            _log.verbose(0, f"hosted HNP: wire-up failed: {e}")
            return
        self.hnp.start_heartbeat_monitor(
            self._on_failure, interval_s=self.interval_s,
            miss_limit=HOSTED_MISS_LIMIT)
        self.hnp.start_name_server()
        self.hnp.start_clock_responder()
        self.hnp.start_series_responder()
        self.hnp.start_ft_responder()
        while not self._stop.is_set() and len(self._done()) < self.n:
            nid = self.hnp.recv_fin(timeout_ms=200)
            if nid is not None:
                self._fin.add(nid)

    def finish(self) -> None:
        """Wait until every node sent FIN or was promoted failed (the
        monitor promotes a node a miss window after its last beat),
        then stop the service thread, every responder and the monitor,
        and close the HNP's endpoint. Called by process 0's finalize
        after its own agent's FIN."""
        if self.error is None and not self.abandoned:
            self._thread.join()
        self.close()

    def close(self) -> None:
        """Stop the service thread (it leaves the modex or the barrier
        within their timeout), then shut the HNP down."""
        self._stop.set()
        self._thread.join(timeout=self.timeout_s + 5)
        self.hnp.shutdown()


def _is_loopback(host: str) -> bool:
    import ipaddress

    if host == "localhost":
        return True
    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return False


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


class DistributedEss(mca_component.Component):
    """Multi-process bootstrap without a launcher: the processes are
    started by hand with ``OMPITPU_COORDINATOR`` (host:port),
    ``OMPITPU_PROCESS_ID`` and ``OMPITPU_NUM_PROCESSES`` (the ess/env +
    ess/pmi analogue). Process 0 hosts the coordinator service
    (:class:`HostedHnp`) at that address; every process, process 0
    included, joins it as a ``WorkerAgent`` at node ``process_id + 1``,
    so the world spans the processes exactly as a ``tpurun`` job of the
    same shape does. ``OMPITPU_JOB_SECRET`` keeps tpurun's meaning: set
    in every process, the OOB is authenticated; set in none, auth is
    off."""

    NAME = "distributed"
    PRIORITY = 50

    #: seconds a process retries its first dial of the coordinator (the
    #: modex's own timeout)
    DIAL_TIMEOUT_S = 30.0

    def register_vars(self) -> None:
        mca_var.register(
            "ess_distributed_coordinator", "str",
            os.environ.get("OMPITPU_COORDINATOR", ""),
            "host:port of the coordinator service process 0 hosts",
        )
        mca_var.register(
            "ess_distributed_process_id", "int",
            int(os.environ.get("OMPITPU_PROCESS_ID", "-1")),
            "this controller's process id within the job (-1 = unset)",
        )
        mca_var.register(
            "ess_distributed_num_processes", "int",
            int(os.environ.get("OMPITPU_NUM_PROCESSES", "0")),
            "total controller processes in the job",
        )

    def query(self, ctx=None):
        if not mca_var.get("ess_distributed_coordinator"):
            return None  # not started under a coordinator address
        return (self.priority, self)

    def bootstrap(self, device: Optional[object] = None):
        addr = str(mca_var.get("ess_distributed_coordinator"))
        pid = int(mca_var.get("ess_distributed_process_id"))
        nprocs = int(mca_var.get("ess_distributed_num_processes"))
        # the JAX package lets jax.distributed auto-detect a cluster
        # when these are unset; there is no cluster to detect here
        if pid < 0:
            raise MPIError(ErrorCode.ERR_ARG,
                           "distributed ESS: OMPITPU_PROCESS_ID "
                           "(ess_distributed_process_id) is unset")
        if nprocs <= 0:
            raise MPIError(ErrorCode.ERR_ARG,
                           "distributed ESS: OMPITPU_NUM_PROCESSES "
                           "(ess_distributed_num_processes) is unset")
        if pid >= nprocs:
            raise MPIError(ErrorCode.ERR_ARG,
                           f"distributed ESS: OMPITPU_PROCESS_ID {pid} is "
                           f"not below OMPITPU_NUM_PROCESSES {nprocs}")
        host, _, port = addr.rpartition(":")
        if not host or not port.isdigit():
            raise MPIError(ErrorCode.ERR_ARG,
                           f"distributed ESS: OMPITPU_COORDINATOR "
                           f"'{addr}' is not host:port")
        discover_devices(device)  # fail on a missing card before binding
        interval = float(mca_var.get("ess_tpurun_heartbeat_interval", 0.5))
        hosted = None
        if pid == 0:
            hosted = HostedHnp(
                nprocs, int(port),
                "127.0.0.1" if _is_loopback(host) else "0.0.0.0", interval)
        _log.verbose(1, f"distributed bootstrap: process {pid}/{nprocs} "
                        f"joins {addr}")
        try:
            boot = wire_up(pid + 1, nprocs, host, int(port), device,
                           dial_timeout_s=self.DIAL_TIMEOUT_S)
        except BaseException:
            if hosted is not None:
                hosted.close()
            raise
        if hosted is not None:
            hosted.abandon_on_uncaught_exception()
            boot["hosted_hnp"] = hosted
        return boot


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

        host, port = os.environ["OMPITPU_HNP"].rsplit(":", 1)
        node_id = int(os.environ["OMPITPU_NODE_ID"])
        num_workers = int(os.environ["OMPITPU_NUM_NODES"])
        if (os.environ.get("OMPITPU_SECRET_STDIN") == "1"
                and not os.environ.get("OMPITPU_JOB_SECRET")):
            # rsh launches ship the job secret on stdin (a command-line
            # env assignment would be world-readable via /proc); it
            # must land before the first endpoint is created
            os.environ["OMPITPU_JOB_SECRET"] = read_stdin_secret(sys.stdin)
        return wire_up(node_id, num_workers, host, int(port), device)


ESS_FRAMEWORK = mca_component.framework(
    "ess", "environment-specific bootstrap (orte/mca/ess analogue)"
)
ESS_FRAMEWORK.register(SingletonEss())
ESS_FRAMEWORK.register(DistributedEss())
ESS_FRAMEWORK.register(TpurunEss())
