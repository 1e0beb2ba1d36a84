"""Checkpoint/restart — drain-then-snapshot sharded checkpoints.

Counterpart of ``ompi_release_tpu/ft/checkpoint.py``. The reference
stack maps as (SURVEY §5 checkpoint/resume):
- crcp/bkmrk "drain in-flight messages" -> quiesce(): barrier + flush
  outstanding PML sends and RMA epochs, then block on async dispatch.
- crs image capture -> sharded pytree save (io.sharded), async so the
  next step's compute overlaps the write. JAX arrays are immutable, so
  an async save there is a snapshot for free; the port's train step
  updates parameters and optimizer state IN PLACE, so an async save
  copies every tensor before :meth:`Checkpointer.save` returns (a clone
  on the tensor's device, which the writers pull to the host): the next
  step cannot change what is written.
- snapc/sstore orchestration/storage -> step-numbered checkpoint dirs
  with a committed marker (a checkpoint is only valid once its marker
  lands, so a crash mid-write is never resumed from), keep-last-N GC.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional

from ..io import sharded
from ..mca import pvar
from ..utils import output
from ..utils.errors import ErrorCode, MPIError

_log = output.stream("ft")
_ckpt_count = pvar.counter("ft_checkpoints_taken", "checkpoints committed")


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3,
                 comm=None, private_dir: bool = False) -> None:
        if comm is not None and getattr(comm, "spans_processes", False) \
                and not private_dir:
            # Snapshot commit is process-local filesystem surgery
            # (rmtree of an existing step dir + rename + keep-last-N
            # GC): two controller processes checkpointing into one
            # shared directory race those steps unsynchronized — one
            # process's commit can rmtree the dir another is renaming
            # into. Refuse with a typed error until the coordinated
            # (rank-0-commits, barrier-fenced) snapshot lands. The ONE
            # safe shape today is a directory no other process touches
            # — declare that explicitly with ``private_dir=True``
            # (e.g. ``dir/rank{pidx}``, the recovery tests' layout).
            raise MPIError(
                ErrorCode.ERR_NOT_AVAILABLE,
                f"Checkpointer on {comm.name}: this communicator spans "
                "controller processes, and the commit protocol "
                "(rmtree/rename/GC) is process-local — concurrent "
                "commits into one directory race. Checkpoint on a "
                "process-local comm (e.g. split_type_shared), or give "
                "each process its own directory and declare it with "
                "private_dir=True",
            )
        self.directory = directory
        self.keep = keep
        self.comm = comm
        self._pending: List = []
        os.makedirs(directory, exist_ok=True)

    # -- quiescence (crcp/bkmrk analogue) ----------------------------------
    def quiesce(self) -> None:
        """Drain communication before snapshotting: no in-flight sends
        or posted receives (the port PML's ``pending_counts``), then a
        barrier."""
        if self.comm is not None:
            pml = getattr(self.comm, "_pml", None)
            if pml is not None:
                unex, posted = pml.pending_counts()
                if posted or unex:
                    raise MPIError(
                        ErrorCode.ERR_PENDING,
                        f"checkpoint with in-flight p2p state "
                        f"({unex} undelivered sends, {posted} posted "
                        "receives) — drain or cancel them first; host "
                        "queues are not part of the snapshot",
                    )
            self.comm.barrier()

    # -- snapshot ----------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def save(self, step: int, state: Any, *, async_: bool = True,
             extra_meta: Optional[Dict] = None) -> None:
        """Snapshot ``state`` (pytree) for ``step``; with ``async_`` the
        state is copied before this returns and written behind it."""
        from ..utils import memchecker

        self.wait()  # one checkpoint in flight at a time
        self.quiesce()
        # a snapshot must not contain donated/consumed buffers — the
        # memchecker liveness walk catches use-after-donation HERE,
        # with provenance, instead of deep inside serialization
        memchecker.assert_all_alive(state, what="checkpoint state")
        d = self._step_dir(step)
        tmp = d + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        meta = {"step": step, "time": time.time()}
        meta.update(extra_meta or {})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        futs = sharded.save_pytree(tmp, state, async_=True) or []

        def commit() -> None:
            if os.path.exists(d):
                shutil.rmtree(d)
            os.rename(tmp, d)
            with open(os.path.join(d, "COMMITTED"), "w") as f:
                f.write(str(step))
            _ckpt_count.add()
            _log.verbose(1, f"checkpoint step {step} committed -> {d}")
            self._gc()

        if async_:
            self._pending = [(futs, commit)]
        else:
            for fu in futs:
                fu.result()
            commit()

    def wait(self) -> None:
        """Block until the in-flight async checkpoint has committed."""
        for futs, commit in self._pending:
            for fu in futs:
                fu.result()
            commit()
        self._pending = []

    def abort(self) -> None:
        """Discard the in-flight checkpoint WITHOUT committing: cancel
        what hasn't started, join what has (so no orphan writer races a
        replayed save into the same tmp dir), and sweep stale tmp
        directories. Used by restart paths where the snapshot taken
        around a failure is suspect."""
        for futs, _commit in self._pending:
            for fu in futs:
                fu.cancel()
            for fu in futs:
                try:
                    fu.result()
                except Exception:
                    pass
        self._pending = []
        for name in os.listdir(self.directory):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    # -- restore -----------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            d = os.path.join(self.directory, name)
            if (name.startswith("step_")
                    and os.path.exists(os.path.join(d, "COMMITTED"))):
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like: Any, step: Optional[int] = None) -> Any:
        """Load the checkpoint for ``step`` (default: latest) into the
        structure of ``like``."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise MPIError(ErrorCode.ERR_FILE,
                           f"no committed checkpoint in {self.directory}")
        return sharded.load_pytree(self._step_dir(step), like)

    def meta(self, step: int) -> Dict:
        with open(os.path.join(self._step_dir(step), "meta.json")) as f:
            return json.load(f)

    # -- retention (sstore GC) ---------------------------------------------
    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
