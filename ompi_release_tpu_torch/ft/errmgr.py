"""Error management policies — the ``orte/mca/errmgr`` analogue
(counterpart of ``ompi_release_tpu/ft/errmgr.py``).

The reference installs a per-role policy component reacting to error
states posted on the state machine (``errmgr_default_orted.c:118-121``);
the response to an unsurvivable failure is job-level
restart-from-checkpoint (SURVEY §5), which ``run_with_restart``
implements: run the step loop,
checkpoint on cadence, and on failure restore the last committed
checkpoint and continue.

``recover`` is the ULFM-era policy layered on top: given a
communicator poisoned by a process failure, either **shrink** (agree
on the survivor group through the coordinator and continue degraded)
or **respawn** (wait for the launcher's resilient respawn to rejoin a
replacement, refresh the modex cards at the new epoch, re-dial the
replacement's wire link, and rebuild a full-size communicator with an
epoch-derived cid). Out-of-job replacement capacity — a controller
that is not under a recovery-enabled ``tpurun`` — is launched through
``comm/spawn.py`` (:func:`spawn_replacements`).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..mca import pvar
from ..utils import output
from ..utils.errors import ErrorCode, MPIError
from .checkpoint import Checkpointer
from .sensor import InjectedFault

_log = output.stream("errmgr")
_restarts = pvar.counter("errmgr_restarts", "restart-from-checkpoint events")
_recoveries = pvar.counter(
    "ft_recoveries",
    "successful ULFM recoveries (shrink or respawn rebuild) completed "
    "by errmgr.recover",
)


class ErrMgr:
    """Callback registry per error class (policy component analogue)."""

    def __init__(self) -> None:
        self._handlers: Dict[type, List[Callable]] = {}

    def register(self, exc_type: type, handler: Callable) -> None:
        self._handlers.setdefault(exc_type, []).append(handler)

    def handle(self, exc: BaseException) -> bool:
        """Run matching handlers; True if any claimed the error."""
        claimed = False
        for t, hs in self._handlers.items():
            if isinstance(exc, t):
                for h in hs:
                    h(exc)
                    claimed = True
        return claimed


def respawn_ready(doc: Optional[Dict]) -> bool:
    """Is the failure picture ready for a full-size rebuild? Nothing
    currently failed, at least one respawn granted, and every granted
    respawn rejoined (``restarted`` is a subset of ``rejoined`` — both
    sets are cumulative across recoveries, so the subset test is what
    distinguishes 'the NEW replacement is wired' from 'some OLD
    recovery's replacement is still in the list')."""
    if not doc or not doc.get("epoch", 0) or doc.get("failed"):
        return False
    restarted = set(doc.get("restarted") or ())
    rejoined = set(doc.get("rejoined") or ())
    return bool(restarted) and restarted <= rejoined


def recover(comm, policy: str = "shrink", *,
            timeout_s: float = 60.0):
    """Recover a working communicator after a member-process failure.

    ``shrink``: ULFM degraded-world recovery — agree on the survivor
    group via the coordinator, return the shrunk communicator (fresh
    epoch-derived cid, rebuilt per-comm collective topology).

    ``respawn``: full-size recovery under a ``tpurun
    --enable-recovery`` job — wait until the launcher's resilient
    respawn brings the replacement through the rejoin service (failure
    picture: ``failed`` empties, the pidx lands in ``rejoined``),
    re-JOIN to refresh the modex card list at the new epoch, re-dial
    the replacement's new OOB listener (``oob_connect`` replaces the
    dead fd), then rebuild a communicator over the FULL original
    group with the epoch-derived cid. The replacement runs this same
    function: on its side the failure picture already shows itself
    rejoined, its bootstrap wire-up already dialed the survivors, and
    the epoch-derived cid makes both sides mint the same channel.

    Returns the recovered communicator; the old one stays revoked.
    """
    if policy == "shrink":
        new = comm.shrink(timeout_ms=int(timeout_s * 1000))
        _recoveries.add()
        return new
    if policy != "respawn":
        raise MPIError(ErrorCode.ERR_ARG,
                       f"unknown recovery policy '{policy}'")
    rt = comm.runtime
    agent = getattr(rt, "agent", None)
    if agent is None or not comm.spans_processes:
        raise MPIError(
            ErrorCode.ERR_NOT_AVAILABLE,
            "respawn recovery needs a tpurun job with "
            "--enable-recovery (the rejoin service respawns the "
            "rank); outside one, launch replacement capacity with "
            "errmgr.spawn_replacements (comm/spawn.py)",
        )
    from ..ft import ulfm as _ulfm
    from ..runtime.wire import proc_topology

    # 1. wait for the replacement: failed drains, and EVERY granted
    # respawn has completed its rejoin — restarted/rejoined are
    # cumulative across recoveries, so "rejoined non-empty" would be
    # satisfied by a PREVIOUS recovery's survivor the instant a new
    # failure's respawn is granted (before the new replacement is
    # anywhere near wired)
    deadline = time.monotonic() + timeout_s
    doc = None
    while time.monotonic() < deadline:
        doc = agent.ft_query()
        if respawn_ready(doc):
            break
        time.sleep(0.1)
    else:
        raise MPIError(
            ErrorCode.ERR_PROC_FAILED,
            f"respawn recovery timed out after {timeout_s}s waiting "
            f"for the replacement to rejoin (picture: {doc})",
        )
    _ulfm.state().apply_notice(doc)
    rejoined = [int(p) for p in doc.get("rejoined", ())]

    # 2. refresh the modex cards at the new epoch (the rejoin service
    # answers JOINs with the CURRENT card list) — in place, so the
    # wire router's reference (and nativewire's) sees the
    # replacement's new address, pid, ring token and incarnation
    me = int(rt.bootstrap["process_index"])
    my_card = agent.cards[me] if me < len(agent.cards) else {}
    cards = agent.run_modex(dict(my_card), timeout_ms=int(
        max(1.0, deadline - time.monotonic()) * 1000))
    rt.bootstrap["peer_cards"][:] = cards
    agent.cards = rt.bootstrap["peer_cards"]

    # 3. re-dial each replacement's new listener (survivors hold a
    # dead fd; the replacement itself skips — its bootstrap wire-up
    # already dialed every survivor). Only THIS recovery's
    # replacements: rejoined is cumulative across recoveries, and a
    # long-rejoined survivor from an earlier one needs no dial — its
    # episode predates this comm
    fat = _ulfm.failed_at_of(doc)
    epoch0 = getattr(comm, "_ft_epoch0", 0)
    for pidx in rejoined:
        if pidx == me:
            continue
        if fat.get(pidx, epoch0) < epoch0:
            continue  # rejoined long before this comm's failure
        card = cards[pidx]
        try:
            agent.ep.connect(pidx + 1, card["oob_host"],
                             int(card["oob_port"]))
        except MPIError as e:
            raise MPIError(
                ErrorCode.ERR_UNREACH,
                f"re-dial of respawned process {pidx} at "
                f"{card.get('oob_host')}:{card.get('oob_port')} "
                f"failed: {e}",
            )

    # 4. rebuild the full-size communicator at the agreed epoch; the
    # agreement doubles as the survivors<->replacement sync point.
    # Keyed on the comm's LINEAGE, not its cid: after recovery #1 a
    # survivor holds rebuild#1 while a fresh replacement holds only
    # its world — the lineage is the one identity both share, so
    # recovery #2's agreement pairs and both mint the same cid
    lineage = getattr(comm, "_ft_lineage", comm.cid)
    adoc = agent.ft_agree(lineage, 1_000_000 + int(doc["epoch"]), 1,
                          proc_topology(comm).procs,
                          timeout_ms=int(
                              max(1.0, deadline - time.monotonic())
                              * 1000))
    epoch = int(adoc.get("epoch", doc["epoch"]))
    from ..comm.communicator import Communicator

    new = Communicator(rt, comm.group,
                       name=f"rebuild({comm.name})", parent=comm,
                       cid=_ulfm.ft_cid(epoch, lineage))
    rt.wire.proc_barrier(new, proc_topology(new).procs)
    _recoveries.add()
    _log.verbose(1, f"respawn recovery: rebuilt {comm.name} -> "
                    f"{new.name} cid={new.cid} at epoch {epoch}")
    return new


def spawn_replacements(argv: List[str], nprocs: int, *,
                       mca: Optional[List[tuple]] = None,
                       timeout_s: float = 300.0):
    """Launch replacement controller capacity as a child job through
    ``comm/spawn.py`` (the MPI_Comm_spawn path) — the out-of-job leg
    of the respawn policy: when THIS controller is not under a
    recovery-enabled tpurun, a dead peer cannot be respawned in
    place, but fresh capacity can be spawned and handed the publish/
    lookup rendezvous to take the failed worker's role. Returns the
    :class:`~..comm.spawn.SpawnedJob` handle once the children
    completed wire-up."""
    from ..comm.spawn import comm_spawn

    job = comm_spawn(argv, nprocs, mca=mca, timeout_s=timeout_s)
    job.wait_running()
    return job


def run_with_restart(
    step_fn: Callable[[int, Any], Any],
    init_state: Any,
    *,
    num_steps: int,
    checkpointer: Checkpointer,
    checkpoint_every: int = 10,
    max_restarts: int = 5,
    recoverable: Tuple[type, ...] = (InjectedFault,),
) -> Tuple[Any, Dict]:
    """Drive ``state = step_fn(step, state)`` for num_steps with
    checkpoint/restart fault tolerance.

    On a recoverable failure: restore the last committed checkpoint
    and resume from its step (deterministic replay of the collective
    schedule — SURVEY §5's recovery model). Non-recoverable exceptions
    propagate.
    """
    stats = {"restarts": 0, "failures": []}
    start = 0
    latest = checkpointer.latest_step()
    state = init_state
    if latest is not None:
        state = checkpointer.restore(init_state, latest)
        start = latest + 1
        _log.verbose(1, f"resuming from checkpoint step {latest}")

    step = start
    while step < num_steps:
        try:
            state = step_fn(step, state)
            if step % checkpoint_every == 0:
                checkpointer.save(step, state)
            step += 1
        except recoverable as e:
            stats["restarts"] += 1
            stats["failures"].append((step, repr(e)))
            _restarts.add()
            if stats["restarts"] > max_restarts:
                raise
            checkpointer.abort()  # in-flight snapshot is suspect
            latest = checkpointer.latest_step()
            if latest is None:
                state = init_state
                step = 0
            else:
                state = checkpointer.restore(init_state, latest)
                step = latest + 1
            _log.verbose(
                1, f"restarted after failure at step {stats['failures'][-1][0]}"
                   f" -> resume at {step}"
            )
    checkpointer.wait()
    return state, stats
