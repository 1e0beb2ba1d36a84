"""MPI_Comm_spawn — the dpm spawn path.

Counterpart of ``ompi_release_tpu/comm/spawn.py``. The reference's
``MPI_Comm_spawn`` (``ompi/mca/dpm/dpm_orte``) asks the runtime to
launch ``maxprocs`` new processes and returns an intercommunicator to
them. Here the launch is a full :class:`~..tools.tpurun.Job` (fork or
ssh, modex, heartbeats, state machine) driven from a background thread,
and the parent<->children channel is the job's own OOB: the spawning
process IS the children's HNP, so it holds a lifeline link to every
child and exchanges tagged frames with them directly (the child's side
is ``Runtime.current().agent.ep``, node 0 being the parent).

The children are separate controllers with devices of their own, so the
handle carries what ``MPI_Comm_spawn``'s intercomm is used for —
addressing the children, messaging them with bytes, learning their exit
code — and no device-data collectives across the boundary, as in the
JAX package.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

from ..native import USER_TAG_BASE as TAG_USER_BASE
from ..utils.errors import ErrorCode, MPIError


class SpawnedJob:
    """Handle to a spawned child job (the intercomm's working parts:
    remote size, addressing, messaging, completion)."""

    def __init__(self, argv: List[str], maxprocs: int, *,
                 mca: Optional[List[tuple]] = None,
                 hosts=None, timeout_s: float = 300.0) -> None:
        from ..tools.tpurun import Job

        if maxprocs < 1:
            raise MPIError(ErrorCode.ERR_SPAWN, "maxprocs must be >= 1")
        self.maxprocs = maxprocs
        self.job = Job(maxprocs, argv, mca or [], hosts=hosts,
                       heartbeat_s=0.5)
        self._rc: Optional[int] = None
        self._error: Optional[BaseException] = None
        self._timeout_s = timeout_s
        self._thread = threading.Thread(
            target=self._run, args=(timeout_s,), daemon=True,
            name="comm-spawn")
        self._thread.start()

    def _run(self, timeout_s: float) -> None:
        try:
            self._rc = self.job.run(timeout_s=timeout_s)
        except BaseException as exc:  # surfaced by wait()/messaging
            self._error = exc

    def wait_running(self, timeout_s: Optional[float] = None) -> None:
        """Block until the children completed wire-up (job RUNNING) —
        the point from which send/recv are valid."""
        from ..runtime.state import JobState

        if timeout_s is None:
            timeout_s = self._timeout_s  # the job's own launch budget
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._error is not None:
                raise MPIError(ErrorCode.ERR_SPAWN,
                               f"spawn failed: {self._error}")
            if self.job.job_state.visited(JobState.RUNNING):
                return
            if not self._thread.is_alive():
                raise MPIError(
                    ErrorCode.ERR_SPAWN,
                    f"spawned job exited before wire-up (rc={self._rc})",
                )
            time.sleep(0.02)
        raise MPIError(ErrorCode.ERR_SPAWN,
                       "spawned job did not reach RUNNING in time")

    def _check_live(self) -> None:
        """Messaging a finished job is an error: the run thread shuts
        the HNP endpoint down at job end."""
        if not self._thread.is_alive():
            raise MPIError(
                ErrorCode.ERR_SPAWN,
                f"spawned job already finished (rc={self._rc}); late "
                "send/recv has no peer",
            )

    # -- the intercomm-ish surface -----------------------------------------
    @property
    def remote_size(self) -> int:
        return self.maxprocs

    def send(self, child_rank: int, tag: int, payload: bytes) -> None:
        """Tagged frame to child ``child_rank`` over its lifeline."""
        if not 0 <= child_rank < self.maxprocs:
            raise MPIError(ErrorCode.ERR_RANK,
                           f"child rank {child_rank} out of range")
        if tag < TAG_USER_BASE:
            raise MPIError(
                ErrorCode.ERR_TAG,
                f"spawn message tags start at {TAG_USER_BASE} (below is "
                "the coordinator control plane)",
            )
        self.wait_running()  # the HNP exists only after launch starts
        self._check_live()
        self.job.hnp.ep.send(child_rank + 1, tag, payload)

    def recv(self, tag: int, *, timeout_ms: int = 30_000
             ) -> Tuple[int, bytes]:
        """One frame from any child; returns (child_rank, payload)."""
        if tag < TAG_USER_BASE:
            raise MPIError(ErrorCode.ERR_TAG,
                           f"spawn message tags start at {TAG_USER_BASE}")
        self.wait_running()
        self._check_live()
        src, _, raw = self.job.hnp.ep.recv(tag=tag, timeout_ms=timeout_ms)
        return src - 1, raw

    def wait(self, timeout_s: float = 300.0) -> int:
        """Join the job; returns its aggregate exit code. A launch that
        died (an exception in the run thread) raises ERR_SPAWN with the
        underlying error."""
        self._thread.join(timeout=timeout_s)
        if self._thread.is_alive():
            raise MPIError(ErrorCode.ERR_PENDING,
                           "spawned job still running")
        if self._error is not None or self._rc is None:
            raise MPIError(ErrorCode.ERR_SPAWN,
                           f"spawned job launch failed: {self._error}")
        return int(self._rc)

    @property
    def running(self) -> bool:
        return self._thread.is_alive()

    def terminate(self) -> None:
        self.job.abort("parent terminated the spawn")


def comm_spawn(command: List[str], maxprocs: int, *,
               mca: Optional[List[tuple]] = None, hosts=None,
               timeout_s: float = 300.0) -> SpawnedJob:
    """``MPI_Comm_spawn`` analogue: launch ``maxprocs`` children and
    return the handle. Children initialize through the normal tpurun
    wire-up (``mpi.init()`` inside a child sees the coordinator) and
    reach the parent at node 0 through ``Runtime.current().agent``."""
    return SpawnedJob(command, maxprocs, mca=mca, hosts=hosts,
                      timeout_s=timeout_s)
