"""Elastic training-step driver — roll a running job through rank
death without a restart (counterpart of
``ompi_release_tpu/parallel/elastic.py``).

The ULFM recovery loop the paper's ORTE layer exists to enable
("process launch, wire-up, FT, I/O fwd", PAPER.md §1), composed from
the pieces the runtime already provides:

  detect    a collective raises ``ERR_PROC_FAILED`` (the coordinator's
            heartbeat/waitpid promotion bumped the job epoch and the
            bounded wire waits stopped parking) or ``ERR_REVOKED`` (a
            peer poisoned the comm first);
  revoke    the survivor that caught the error revokes the comm so
            every peer's pending op is interrupted too;
  rebuild   ``errmgr.recover`` either shrinks (degraded world) or
            waits out the launcher's respawn and rebuilds full-size;
  rollback  the survivors agree (MIN-allreduce on the NEW comm) on the
            last checkpoint step everyone holds committed, restore it,
            and continue — deterministic replay from the snapshot.

A step function sees the CURRENT communicator (``step_fn(step, state,
comm)``) because recovery swaps it. Checkpoints must live in a
process-private directory (``ft/checkpoint.py``'s ``private_dir``
contract); the rollback agreement is what keeps them consistent.

Chaos hooks: the ``sensor_ft_*`` cvars (see ``ft/sensor.py``) arm an
:class:`~..ft.sensor.FtTester` per driver — probabilistic or
every-N-steps ``InjectedFault``s (recovered locally, no comm rebuild)
and the ``tpurun --ft-inject rank:step`` hard SIGKILL used by the
recovery job tests.

With obs on, each recovery is one ``ft_recovery`` span (layer ``ft``,
the failed step in the peer slot) in the journal the doctor's incident
timeline reads.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from .. import obs as _obs
from ..ft import ulfm as _ulfm
from ..ft import errmgr as _errmgr
from ..ft.checkpoint import Checkpointer
from ..ft.sensor import FtTester, InjectedFault
from ..mca import pvar
from ..utils import output
from ..utils.errors import ErrorCode, MPIError

_log = output.stream("elastic")

_recovery_seconds = pvar.timer(
    "ft_recovery_seconds",
    "wall time from catching a failure in the step loop to resuming "
    "with a rebuilt communicator and restored checkpoint",
)
_steps_lost = pvar.counter(
    "ft_steps_lost",
    "training steps recomputed after rollbacks (failure step minus "
    "resume step, summed over recoveries)",
)

#: error classes that mean "a peer is gone" outright
_CONFIRMED = (ErrorCode.ERR_PROC_FAILED, ErrorCode.ERR_REVOKED)
#: error classes that SUGGEST a peer died before the epoch bump landed
#: (mid-transfer truncation, link loss, a reap timeout); recovery only
#: proceeds once the coordinator's failure picture confirms
_SUSPECT = (ErrorCode.ERR_TRUNCATE, ErrorCode.ERR_UNREACH,
            ErrorCode.ERR_PENDING)


class ElasticStep:
    """Drive ``state = step_fn(step, state, comm)`` with ULFM
    revoke/rebuild/rollback fault tolerance.

    ``policy``: ``"shrink"`` continues degraded on the survivors;
    ``"respawn"`` (under ``tpurun --enable-recovery``) waits for the
    replacement and continues full-size. ``InjectedFault`` from the
    armed :class:`FtTester` is always recovered locally (rollback
    only — the fleet is intact).
    """

    def __init__(self, comm, step_fn: Callable[[int, Any, Any], Any],
                 checkpointer: Checkpointer, *,
                 policy: str = "shrink",
                 checkpoint_every: int = 1,
                 max_recoveries: int = 3,
                 confirm_timeout_s: float = 15.0,
                 recover_timeout_s: float = 60.0,
                 tester: Optional[FtTester] = None) -> None:
        if policy not in ("shrink", "respawn"):
            raise MPIError(ErrorCode.ERR_ARG,
                           f"unknown elastic policy '{policy}'")
        self.comm = comm
        self.step_fn = step_fn
        self.checkpointer = checkpointer
        self.policy = policy
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.max_recoveries = max_recoveries
        self.confirm_timeout_s = confirm_timeout_s
        self.recover_timeout_s = recover_timeout_s
        # chaos hook: armed from the sensor_ft_* cvars unless the
        # caller provides a tester (tests)
        self.tester = tester if tester is not None else FtTester.from_cvars(
            process_index=int(getattr(comm, "runtime").bootstrap.get(
                "process_index", 0)) if getattr(comm, "runtime", None)
            else 0)
        if (getattr(comm, "spans_processes", False)
                and self.tester.fail_prob > 0
                and getattr(self.tester, "seed", None) is None):
            # UNSEEDED probabilistic injection desynchronizes a
            # spanning comm: one rank rolls back (and posts the
            # rollback agreement collective) while peers post the
            # step's collective — mismatched schedules pair on the
            # comm's channel. Seeded injection fires at the SAME step
            # on every rank (same seed, same call sequence), which is
            # also what makes chaos runs replayable; every-N and the
            # armed kill are synchronized/real by construction.
            raise MPIError(
                ErrorCode.ERR_ARG,
                "unseeded probabilistic fault injection on a "
                "communicator spanning controller processes would "
                "desynchronize the collective schedule across ranks — "
                "set the sensor_ft_seed cvar (same seed fleet-wide) "
                "or use sensor_ft_every_n",
            )
        self.stats: Dict[str, Any] = {
            "recoveries": 0, "injected_rollbacks": 0,
            "failures": [], "steps_lost": 0, "policy": policy,
        }

    # -- helpers -----------------------------------------------------------
    def _agent(self):
        return getattr(self.comm.runtime, "agent", None)

    def _is_replacement(self) -> bool:
        """A respawned incarnation in a recovering job must not
        resume on the original comm — the survivors are waiting at
        the rebuild. The discriminator is the launcher's
        ``OMPITPU_INCARNATION`` marker (exported into respawned
        children only): it is authoritative and race-free, unlike any
        read of the failure picture — the rejoin epoch bump can land
        before OR after the moment the app samples it, and the
        cumulative rejoined set also names long-recovered survivors."""
        import os as _os

        if self.policy != "respawn" or self._agent() is None:
            return False
        return bool(int(_os.environ.get("OMPITPU_INCARNATION", "0")
                        or 0))

    def _confirm_failure(self, exc: MPIError) -> None:
        """Suspect errors recover only once the coordinator confirms a
        failure — a flaky transfer without a dead peer must surface,
        not trigger a silent rollback. Confirmation keys on the
        PERMANENT episode record (``dead_for`` against this comm's
        birth epoch), not the transient ``failed`` set: under the
        respawn policy the coordinator moves a corpse from failed to
        restarted milliseconds after promotion, and a suspect error
        surfacing after that bump must still confirm."""
        if exc.code in _CONFIRMED:
            return
        agent = self._agent()
        procs = set(self.comm._member_procs())
        epoch0 = getattr(self.comm, "_ft_epoch0", 0)
        deadline = time.monotonic() + self.confirm_timeout_s
        while time.monotonic() < deadline:
            if _ulfm.state().dead_for(procs, epoch0):
                return
            if agent is not None:
                try:
                    doc = agent.ft_query(timeout_ms=2000)
                    _ulfm.state().apply_notice(doc)
                    if _ulfm.state().dead_for(procs, epoch0):
                        return
                except MPIError:
                    pass
            time.sleep(0.1)
        raise exc

    def _rollback(self, init_like: Any) -> Tuple[Any, int]:
        """Agree on the rollback step (MIN over the new comm of each
        process's latest committed checkpoint), restore it, and return
        ``(state, resume_step)``. A process with no committed
        checkpoint forces a from-scratch restart for everyone —
        deterministic replay needs one common snapshot."""
        from .. import ops as _ops
        from ..utils.arrays import to_numpy

        latest = self.checkpointer.latest_step()
        mine = -1 if latest is None else int(latest)
        if self.comm.size > 1 or self.comm.spans_processes:
            local_n = max(1, len(self.comm.local_comm_ranks))
            x = np.full((local_n, 1), mine, np.int32)
            agreed = int(to_numpy(
                self.comm.allreduce(x, _ops.MIN))[0][0])
        else:
            agreed = mine
        if agreed < 0:
            return init_like, 0
        state = self.checkpointer.restore(init_like, agreed)
        return state, agreed + 1

    def _recover(self, step: int, exc: MPIError) -> int:
        """Revoke -> rebuild -> rollback; returns the resume step."""
        self.stats["recoveries"] += 1
        self.stats["failures"].append((step, repr(exc)))
        if self.stats["recoveries"] > self.max_recoveries:
            raise exc
        rec = _obs.enabled  # capture once: flag may flip mid-recovery
        t0 = time.perf_counter()
        try:
            self.comm.revoke()
        except MPIError:
            pass  # already revoked / peers already told
        self.checkpointer.abort()  # in-flight snapshot is suspect
        self.comm = _errmgr.recover(self.comm, self.policy,
                                    timeout_s=self.recover_timeout_s)
        self._state, resume = self._rollback(self._init_like)
        lost = max(0, step - resume)
        self.stats["steps_lost"] += lost
        for _ in range(lost):
            _steps_lost.add()
        dt = time.perf_counter() - t0
        _recovery_seconds.add(dt)
        if rec and _obs.enabled:
            _obs.record("ft_recovery", "ft", t0, dt,
                        comm_id=self.comm.cid, peer=step)
        _log.verbose(
            0, f"recovered from failure at step {step} in {dt:.3f}s "
               f"({self.policy}); resuming at {resume} on "
               f"{self.comm.name}")
        return resume

    # -- the loop ----------------------------------------------------------
    def run(self, init_state: Any, num_steps: int) -> Tuple[Any, Dict]:
        self._init_like = init_state
        self._state = init_state
        if self._is_replacement():
            # replacement fast path: rebuild with the waiting
            # survivors, then restore the agreed snapshot
            self.comm = _errmgr.recover(
                self.comm, "respawn", timeout_s=self.recover_timeout_s)
            self._state, step = self._rollback(init_state)
            _log.verbose(0, f"replacement rejoined on {self.comm.name}; "
                            f"resuming at step {step}")
        else:
            latest = self.checkpointer.latest_step()
            if latest is not None:
                self._state = self.checkpointer.restore(init_state,
                                                        latest)
                step = latest + 1
            else:
                step = 0
        while step < num_steps:
            try:
                self.tester.step()  # chaos: may raise / may SIGKILL us
                self._state = self.step_fn(step, self._state, self.comm)
                if step % self.checkpoint_every == 0:
                    self.checkpointer.save(step, self._state,
                                           async_=False)
                step += 1
            except InjectedFault as e:
                # local injected fault: the fleet is intact — rollback
                # without touching the communicator
                self.stats["injected_rollbacks"] += 1
                self.stats["failures"].append((step, repr(e)))
                if self.stats["injected_rollbacks"] > self.max_recoveries:
                    raise
                self.checkpointer.abort()
                self._state, step = self._rollback(init_state)
            except MPIError as e:
                if e.code not in _CONFIRMED + _SUSPECT:
                    raise
                self._confirm_failure(e)  # re-raises if unconfirmed
                step = self._recover(step, e)
        self.checkpointer.wait()
        return self._state, self.stats
