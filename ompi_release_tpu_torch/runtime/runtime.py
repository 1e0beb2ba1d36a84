"""Runtime bring-up/teardown — the ``MPI_Init``/``orte_init`` analogue.

Counterpart of ``ompi_release_tpu/runtime/runtime.py``, init/finalize,
the async progress engine's thread and the ``runtime_timing`` init
report (the wire, observability, ULFM and retune arms are not ported
yet). The bring-up
sequence mirrors ``ompi_mpi_init.c``:

  1. config/core var registration        (opal_init_util)
  2. ESS select + bootstrap              (orte_init/ess.init)
  3. allocation → rank mapping           (ras/rmaps)
  4. modex                               (grpcomm modex)
  5. WORLD/SELF communicator creation    (ompi_comm_init)
  6. coll component selection per comm   (mca_coll_base_comm_select)

with the ORTE job state machine activated at each boundary. WORLD lives
on ``cuda:0`` unless the caller passes ``device="cpu"``.
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
        self.world = None
        self.self_comm = None
        self.initialized = False
        self.finalized = False

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
            self.job_state.activate(JobState.INIT)

            # 2. ESS bootstrap (identity + device discovery)
            ess = ess_mod.ESS_FRAMEWORK.select()
            self.bootstrap = ess.bootstrap(device)
            self.job_state.activate(JobState.ALLOCATE, self.bootstrap)

            # 3. rank mapping
            self.mesh = mesh_mod.build_mesh(
                mesh_mod.rank_devices(self.bootstrap["devices"]))
            self.job_state.activate(JobState.MAP, self.mesh)
            self.job_state.activate(JobState.VM_READY)

            # 4. modex
            self.endpoints = mesh_mod.run_modex(self.mesh)
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

    def finalize(self) -> None:
        with _lock:
            if not self.initialized or self.finalized:
                return
            # stop the progress engine BEFORE communicators are torn
            # down: a schedule on the progress thread still uses them
            from ..comm import communicator as comm_mod
            from . import progress as _progress

            _progress.engine().shutdown()
            comm_mod.clear_comm_registry()
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
