"""Runtime bring-up/teardown — the ``MPI_Init``/``orte_init`` analogue.

Counterpart of ``ompi_release_tpu/runtime/runtime.py``, init/finalize,
the async progress engine's thread, the ``runtime_timing`` init report
the unified multi-process world under ``tpurun`` and its ULFM watcher
(the observability and retune arms are not ported yet). The bring-up
sequence mirrors
``ompi_mpi_init.c``:

  1. config/core var registration        (opal_init_util)
  2. ESS select + bootstrap              (orte_init/ess.init)
  3. allocation → rank mapping           (ras/rmaps)
  4. modex                               (grpcomm modex)
  5. WORLD/SELF communicator creation    (ompi_comm_init)
  6. coll component selection per comm   (mca_coll_base_comm_select)

with the ORTE job state machine activated at each boundary. WORLD lives
on ``cuda:0`` unless the caller passes ``device="cpu"``.

Under ``tpurun`` the ESS runs the coordinator wire-up and every worker's
modex card names how many ranks it owns: with ``runtime_unified_world``
(default on) COMM_WORLD spans every worker — process p owns a
contiguous span of world ranks, and other processes' ranks are reached
through the wire router (``runtime/wire.py``).
"""

from __future__ import annotations

import atexit
import threading
from typing import Any, Dict, List, Optional

from ..mca import var as mca_var
from ..utils import output
from ..utils.errors import ErrorCode, MPIError
from . import ess as ess_mod
from . import mesh as mesh_mod
from .state import JobState, StateMachine

_log = output.stream("runtime")
_lock = threading.RLock()


class Runtime:
    """Process-global runtime instance (``ompi_mpi_state`` analogue)."""

    _instance: Optional["Runtime"] = None

    def __init__(self) -> None:
        self.job_state = StateMachine("job")
        self.mesh: Optional[mesh_mod.Mesh] = None
        self.endpoints: List[mesh_mod.Endpoint] = []
        self.bootstrap: Dict[str, Any] = {}
        self.agent = None  # tpurun WorkerAgent (set by the tpurun ESS)
        self.world = None
        self.self_comm = None
        self.initialized = False
        self.finalized = False
        # unified multi-controller world (tpurun): this process owns
        # world ranks [local_rank_offset, local_rank_offset+local_size)
        # and reaches every other process's ranks through the wire
        self.unified = False
        self.local_rank_offset = 0
        self.local_size = 0
        self.proc_spans: List[tuple] = []
        self.wire = None  # WireRouter when unified

    @classmethod
    def current(cls) -> "Runtime":
        with _lock:
            if cls._instance is None:
                cls._instance = Runtime()
            return cls._instance

    @classmethod
    def is_initialized(cls) -> bool:
        with _lock:
            return cls._instance is not None and cls._instance.initialized

    def init(self, cli_args: Optional[List[str]] = None, device=None):
        with _lock:
            if self.initialized:
                return self.world
            if self.finalized:
                raise MPIError(
                    ErrorCode.ERR_OTHER,
                    "runtime re-init after finalize is not supported "
                    "(matches MPI_Init-after-MPI_Finalize)",
                )

            # 1. core vars + CLI
            mesh_mod.register_vars()
            from .wire import register_vars as _wire_register_vars

            _wire_register_vars()  # wire transport cvars: visible even
            #                        in singleton mode
            mca_var.register(
                "runtime_unified_world", "bool", True,
                "Under tpurun, form ONE COMM_WORLD spanning every "
                "worker process (cross-process ranks reachable through "
                "the wire router); false = each process's world spans "
                "only its local ranks",
            )
            mca_var.register(
                "runtime_timing", "bool", False,
                "Report per-stage init timing after bring-up (the "
                "ompi_timing var, ompi_mpi_init.c:366-371,617-625)",
            )
            # the frameworks the collectives read register their vars
            # now: a registration inside a first collective would move
            # the write generation and void the plan it froze
            from ..coll import plan as _plan  # noqa: F401  coll_compiled
            from ..ops import op as op_mod

            op_mod.OP_FRAMEWORK.open()
            if cli_args:
                mca_var.VARS.apply_cli(_parse_mca_cli(cli_args))

            # observability plane hooks (cold path; one attr check when
            # off): ``--mca obs_enable 1`` given here turns the plane
            # on, then the stall-watchdog gate is re-derived now that
            # CLI/env cvars are final, and the SIGUSR1/fatal-signal
            # flight-recorder dumps are installed
            from .. import obs as _obs

            if not _obs.enabled and bool(mca_var.get("obs_enable", False)):
                _obs.enable()
            if _obs.enabled:
                from ..obs import watchdog as _obs_watchdog

                _obs_watchdog.refresh(True)
                _obs_watchdog.install_signal_handlers()
            self.job_state.activate(JobState.INIT)

            # 2. ESS bootstrap (identity + device discovery)
            ess = ess_mod.ESS_FRAMEWORK.select()
            self.bootstrap = ess.bootstrap(device)
            self.agent = self.bootstrap.get("agent")  # tpurun WorkerAgent
            self.job_state.activate(JobState.ALLOCATE, self.bootstrap)

            if self.agent is not None:
                # ULFM detection plane: TAG_PROC_FAILED epoch notices
                # and TAG_FT_REVOKE poison frames feed the process-
                # local failure picture the wire router's bounded
                # waits consult — armed before the first collective so
                # a failure during bring-up is already visible
                from ..ft import ulfm as _ulfm

                _ft = _ulfm.state()
                self.agent.start_ft_watcher(_ft.apply_notice,
                                            _ft.apply_revoke)

            if _obs.enabled and self.agent is not None:
                # estimate the clock offset NOW, not only at finalize:
                # a hung job killed mid-run leaves postmortems as its
                # only artifact, and without an offset their merged
                # timeline is garbage across controllers (finalize
                # re-estimates for the journal dump; drift over one
                # job is negligible next to OOB rtt)
                try:
                    off, rtt = self.agent.clock_sync()
                    _obs.set_clock(off, rtt)
                except Exception as e:
                    _log.verbose(1, f"obs clock sync skipped: {e}")
            if _obs.enabled:
                # arm the continuous pvar sampler (the fleet metrics
                # plane) — no-op unless obs_sample_interval > 0, and
                # the clock offset above is already in place so pushed
                # series points merge onto the HNP timeline
                try:
                    from ..obs import sampler as _obs_sampler

                    _obs_sampler.maybe_start(self)
                except Exception as e:
                    _log.verbose(1, f"obs sampler start skipped: {e}")

            # 3. rank mapping
            self.mesh = mesh_mod.build_mesh(
                mesh_mod.rank_devices(self.bootstrap["devices"]))
            self.job_state.activate(JobState.MAP, self.mesh)
            self.job_state.activate(JobState.VM_READY)

            # 4. modex (endpoint allgather; under tpurun the peer
            # processes' cards came through the coordinator)
            self.endpoints = mesh_mod.run_modex(self.mesh)
            peer_cards = self.bootstrap.get("peer_cards") or []
            if (self.agent is not None and len(peer_cards) > 1
                    and bool(mca_var.get("runtime_unified_world", True))
                    and all("local_device_count" in c for c in peer_cards)):
                self._build_unified_world(peer_cards)
            self.job_state.activate(JobState.RUNNING)

            # 5-6. communicators + per-comm coll selection
            from ..comm import world as comm_world

            self.world, self.self_comm = comm_world.create_world(self)
            self.job_state.activate(JobState.REGISTERED)

            # async progress engine: arm the dedicated thread when the
            # operator opted in (posts arm it lazily too)
            from . import progress as _progress

            _progress.engine().ensure_thread()
            self.initialized = True
            _log.verbose(1, f"initialized: {len(self.endpoints)} ranks on "
                            f"{self.mesh.shape} mesh")
            if mca_var.get("runtime_timing", False):
                self._report_init_timing()
            return self.world

    def _report_init_timing(self) -> None:
        """The ``ompi_timing`` report: per-stage durations from the job
        state machine's timestamped history (``ompi_mpi_init.c:435-437,
        617-625``)."""
        hist = self.job_state.history()
        if len(hist) < 2:
            return
        total = (hist[-1][0] - hist[0][0]) * 1e3
        _log.info(f"init timing (total {total:.1f} ms):")
        for (t0, s0, _), (t1, _, _) in zip(hist, hist[1:]):
            name = self.job_state._fmt(s0)
            _log.info(f"  {name:<14} {(t1 - t0) * 1e3:8.1f} ms")

    def _build_unified_world(self, peer_cards: List[Dict]) -> None:
        """Form the union world: every process's ranks become world
        ranks (process p owns a contiguous span), with peer-process
        ranks represented by endpoints synthesized from their modex
        cards — the ``add_procs``-over-all-peers step of
        ``ompi_mpi_init.c:759-786``. Cross-process pairs are reached
        through the wire router (shm handoff on one host, DCN staging
        across hosts), never by a device copy."""
        import dataclasses as _dc

        from .wire import WireRouter

        my_pidx = int(self.bootstrap["process_index"])
        counts = [int(c["local_device_count"]) for c in peer_cards]
        local_eps = self.endpoints
        if counts[my_pidx] != len(local_eps):
            raise MPIError(
                ErrorCode.ERR_OTHER,
                f"unified world needs the full local rank set: modex "
                f"card advertised {counts[my_pidx]} ranks but the "
                f"mesh holds {len(local_eps)}",
            )
        offsets = [0] * len(counts)
        for p in range(1, len(counts)):
            offsets[p] = offsets[p - 1] + counts[p - 1]
        host = str(peer_cards[my_pidx].get("host", ""))
        endpoints: List[mesh_mod.Endpoint] = []
        for p, card in enumerate(peer_cards):
            if p == my_pidx:
                endpoints.extend(
                    _dc.replace(ep, rank=offsets[p] + ep.rank,
                                process_index=p, host=host)
                    for ep in local_eps
                )
            else:
                endpoints.extend(
                    mesh_mod.Endpoint(
                        rank=offsets[p] + li,
                        device_id=li,
                        process_index=p,
                        platform=str(card.get("platform", "unknown")),
                        device_kind="peer-process",
                        coords=(li,),
                        slice_index=0,
                        host=str(card.get("host", "")),
                    )
                    for li in range(counts[p])
                )
        self.endpoints = endpoints
        self.unified = True
        self.local_rank_offset = offsets[my_pidx]
        self.local_size = counts[my_pidx]
        self.proc_spans = [(offsets[p], counts[p])
                           for p in range(len(counts))]
        self.wire = WireRouter(self)
        _log.verbose(
            1,
            f"unified world: {sum(counts)} ranks over "
            f"{len(counts)} processes; local span "
            f"[{self.local_rank_offset}, "
            f"{self.local_rank_offset + self.local_size})",
        )

    def finalize(self) -> None:
        with _lock:
            if not self.initialized or self.finalized:
                return
            from .. import obs as _obs

            if _obs.enabled:
                # disarm the sampler FIRST (its final tick + push run
                # over the still-live HNP link), then the per-rank
                # journal, series, ledger and native-event dumps
                # (obs_dump_dir) BEFORE the agent closes: the
                # clock-offset estimate in their meta needs the live
                # HNP link
                try:
                    from ..obs import sampler as _obs_sampler

                    _obs_sampler.stop(final_push=True)
                except Exception as e:
                    _log.verbose(1, f"obs sampler stop failed: {e}")
                try:
                    from ..obs import export as _obs_export

                    _obs_export.maybe_dump_rank_journal(self)
                    _obs_export.maybe_dump_series(self)
                    _obs_export.maybe_dump_ledger(self)
                    _obs_export.maybe_dump_nativeev(self)
                except Exception as e:
                    _log.verbose(1, f"obs rank-journal dump failed: {e}")
            # stop the progress engine BEFORE communicators are torn
            # down: a schedule on the progress thread still uses them
            from ..comm import communicator as comm_mod
            from . import progress as _progress

            _progress.engine().shutdown()
            from ..comm import dpm as dpm_mod

            dpm_mod.clear()
            comm_mod.clear_comm_registry()
            svc = getattr(self, "_win_service", None)
            if svc is not None:
                svc.stop()
                self._win_service = None
            if self.agent is not None:
                # report clean completion to the HNP (IOF_COMPLETE ->
                # TERMINATED flow of plm_types.h:113-151) and drop the
                # lifeline deliberately
                try:
                    self.agent.send_fin()
                except MPIError:
                    pass  # the launcher already tore the job down
                self.agent.close()
                self.agent = None
            self.job_state.activate(JobState.TERMINATED)
            self.finalized = True
            self.initialized = False

    @property
    def world_size(self) -> int:
        return len(self.endpoints)


def _parse_mca_cli(argv: List[str]) -> List[tuple]:
    """Extract ``--mca key value`` pairs (orterun CLI analogue)."""
    pairs = []
    i = 0
    while i < len(argv):
        if argv[i] == "--mca" and i + 2 < len(argv):
            pairs.append((argv[i + 1], argv[i + 2]))
            i += 3
        else:
            i += 1
    return pairs


def init(cli_args: Optional[List[str]] = None, **kw):
    """Module-level MPI_Init analogue; returns COMM_WORLD."""
    return Runtime.current().init(cli_args=cli_args, **kw)


def finalize() -> None:
    rt = Runtime._instance
    if rt is not None:
        rt.finalize()


def _reset_for_tests() -> None:
    """Finalize and drop the process-global runtime so the next
    ``init()`` builds a fresh one (test isolation only: MPI forbids
    re-init after finalize)."""
    with _lock:
        finalize()
        Runtime._instance = None


atexit.register(finalize)
