"""MPI-2 dynamics: connect/accept over opened ports (dpm).

Counterpart of ``ompi_release_tpu/comm/dpm.py`` (reference:
``ompi/mca/dpm/dpm_orte/dpm_orte.c``, the connect/accept handshake over
the runtime's OOB). The name service (``MPI_Publish_name`` /
``MPI_Lookup_name``, ``pubsub_orte``) lives in ``runtime/pubsub.py`` and
is re-exported here: one name table per process (a singleton) or per job
(the HNP's, under tpurun), never a second one in this module.

``lookup_name`` here is the name service's lookup followed by this
module's port check (:func:`check_port`); ``comm`` exports this one.

A *port* (``MPI_Open_port``) is an opaque string naming a pending
acceptor. This module keeps the port table: every port this process
opened, and the rendezvous of the ones still open. ``comm_accept``
parks on a port until a connector arrives; ``comm_connect`` completes
the rendezvous; both sides receive mirrored
:class:`~.intercomm.Intercommunicator` handles over the two groups.
Arrivals pair FIFO with the opposite queue's head, and each pairing is
built outside the lock with its own result, so one slow construction
never stalls another pairing on the same port.

Within one process the rendezvous pairs threads of the controller, as in
the JAX package. Under tpurun a port names its owner process
(``tpu-port:<process>.<n>``), and a connector in another process reaches
the parked acceptor over the OOB: it sends its group's world ranks to
the owner, the owner pairs it with the head acceptor and replies with
the acceptor's group and a block of cids it reserved
(:class:`~.communicator.CidBlock`), and both processes build the same
intercommunicator pair from that block. Only the processes taking part
create a pair, so under tpurun every pair, the process-local ones too,
takes its cids from such a block and never from the shared counter the
other workers' communicators rely on. The JAX package's rendezvous is
process-local: a connect to another process's port raises ``ERR_PORT``
there.

A closed ``tpu-port:`` that is still published is a dead name:
``lookup_name`` raises ``ERR_PROC_FAILED`` for it (the check is
:func:`check_port`). Under tpurun an open port also holds a marker name
in the job's table (published by ``open_port``, withdrawn by
``close_port``), so a worker's lookup of another worker's port sees its
closure.

ULFM: a port remembers the job epoch it was opened at and refuses
joiners whose plan predates it; a parked rendezvous whose counterpart
communicator was revoked or freed, or whose member process the job
epoch marks failed, fails at once with the typed error
(``_check_counterpart``).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from ..native import DssBuffer
from ..runtime import pubsub as _pubsub
from ..runtime.pubsub import publish_name, unpublish_name
from ..utils import output
from ..utils.cids import DPM_CID_BLOCK, dpm_block_base
from ..utils.errors import ErrorCode, MPIError
from .communicator import CidBlock, Communicator, cids_in_use
from .group import Group
from .intercomm import Intercommunicator

_log = output.stream("dpm")

__all__ = ["open_port", "close_port", "comm_accept", "comm_connect",
           "publish_name", "unpublish_name", "lookup_name", "clear",
           "check_port"]

_port_counter = itertools.count(0)
_lock = threading.Condition()

#: port -> rendezvous slot (the ports still open)
_pending: Dict[str, "_Rendezvous"] = {}
#: every port this process opened (closed ones stay: a lookup of a
#: closed port is a dead name, not an opaque value)
_opened: Set[str] = set()

PORT_PREFIX = "tpu-port:"
#: the job-global marker of an open port under tpurun
_OPEN_PREFIX = "tpu-port-open:"
#: how long a lookup waits for another worker's open marker (the HNP's
#: name server answers within a few of its 50 ms polls)
_MARKER_WAIT_S = 1.5

#: cross-process rendezvous channels (far above USER_TAG_BASE, beside
#: the wire router's and the window service's blocks)
TAG_DPM_CONNECT = 9 << 20
TAG_DPM_REPLY = (9 << 20) + 1
_DPM_MAGIC = "DPM1"
_token = itertools.count(1)

_block_counter = itertools.count(0)


class _Party:
    """One parked accept/connect caller. ``pairing`` is set when the
    matchmaker pairs it; ``error`` fails it individually (close_port,
    finalize teardown). A connector in another process is a party with
    ``group`` and ``remote`` = (process index, token) and no comm."""

    __slots__ = ("comm", "side", "pairing", "error", "group", "remote")

    def __init__(self, comm: Optional[Communicator], side: str,
                 group: Optional[Group] = None,
                 remote: Optional[Tuple[int, int]] = None) -> None:
        self.comm = comm
        self.side = side
        self.group = group if group is not None else comm.group
        self.remote = remote
        self.pairing: Optional["_Pairing"] = None
        self.error: Optional[BaseException] = None


class _Pairing:
    """One matched (acceptor, connector) pair mid-construction, with its
    OWN result/error: a port is a meeting point for many concurrent
    pairings, so one slow or failed construction never serializes or
    poisons another."""

    __slots__ = ("port", "acceptor", "connector", "result", "error")

    def __init__(self, port: str, acceptor: _Party,
                 connector: _Party) -> None:
        self.port = port
        self.acceptor = acceptor
        self.connector = connector
        self.result: Optional[Tuple[Intercommunicator,
                                    Intercommunicator]] = None
        self.error: Optional[BaseException] = None


class _Rendezvous:
    """One port's meeting point: FIFO queues of parked parties per
    side, and the job epoch the port was opened at (joiners carrying a
    stale epoch are refused)."""

    def __init__(self, port: str) -> None:
        self.port = port
        self.acceptors: List[_Party] = []
        self.connectors: List[_Party] = []
        self.epoch = _ft_epoch()


def _ft_epoch() -> int:
    """The job's failure epoch (``ft/ulfm``)."""
    from ..ft import ulfm

    return ulfm.state().epoch


def _check_counterpart(comm: Optional[Communicator],
                       port: str, side: str) -> None:
    """Fast-fail instead of burning the caller's whole timeout: a
    rendezvous whose registered counterpart communicator has been
    revoked (or belongs to a failed process picture) is DEAD — raise
    the typed ULFM error now."""
    if comm is None:
        return
    if getattr(comm, "_revoked", False) or getattr(comm, "_freed", False):
        raise MPIError(
            ErrorCode.ERR_REVOKED,
            f"{side} on '{port}': the parked peer's communicator "
            f"({comm.name}) was revoked/freed — the rendezvous is dead",
        )
    from ..ft import ulfm

    ulfm.state().check_wait(comm.cid, comm._member_procs(),
                            f"{side} on '{port}' awaiting process",
                            epoch0=getattr(comm, "_ft_epoch0", 0))


def _check_disjoint(a: Group, b: Group) -> None:
    if set(a.world_ranks) & set(b.world_ranks):
        raise MPIError(ErrorCode.ERR_GROUP,
                       "connect/accept groups must be disjoint")


def _runtime():
    from ..runtime.runtime import Runtime

    return Runtime._instance


def _job_pidx() -> Optional[int]:
    """This worker's process index under tpurun (None in a singleton)."""
    rt = _runtime()
    if rt is None or getattr(rt, "agent", None) is None:
        return None
    return int(rt.bootstrap["process_index"])


def _owner_of(port: str) -> Optional[int]:
    """The process a tpurun port names (None: a singleton's port)."""
    body = port[len(PORT_PREFIX):]
    if "." not in body:
        return None
    try:
        return int(body.split(".", 1)[0])
    except ValueError:
        return None


def _new_cid_block() -> Optional[CidBlock]:
    """The cids of a new pair: a block of the reserved band under tpurun
    (block ``n * process_count + process_index``, so no two owners ever
    pick the same one), None in a singleton (the shared counter: one
    process, nothing to agree with)."""
    pidx = _job_pidx()
    if pidx is None:
        return None
    nproc = int(_runtime().bootstrap["process_count"])
    for n in _block_counter:
        base = dpm_block_base(n * nproc + pidx)
        if not cids_in_use(base, DPM_CID_BLOCK):
            return CidBlock(base, DPM_CID_BLOCK)
    raise AssertionError("unreachable")


def _build_intercomm(pr: _Pairing, runtime) -> None:
    """Construct one pairing's mirrored pair OUTSIDE the lock, then
    publish result/error on the pairing under the lock; a remote
    connector gets its reply (the acceptor's group and the pair's cid
    block) first, or the error."""
    try:
        block = _new_cid_block()
        pair = Intercommunicator.create(
            runtime, pr.acceptor.group, pr.connector.group,
            name=f"accept({pr.port})", cid_block=block,
        )
        if pr.connector.remote is not None:
            _reply(pr.connector.remote, True, pr.acceptor.group, "",
                   block.base)
    except BaseException as exc:
        if pr.connector.remote is not None:
            try:
                _reply(pr.connector.remote, False, None, str(exc))
            except MPIError:
                pass  # link gone: the connector times out on its own
        with _lock:
            pr.error = exc
            _lock.notify_all()
        return
    with _lock:
        pr.result = pair
        _lock.notify_all()


def _withdraw(rv: _Rendezvous, me: _Party) -> None:
    """Remove a parked party from its queue. Caller holds _lock."""
    q = rv.acceptors if me.side == "accept" else rv.connectors
    try:
        q.remove(me)
    except ValueError:
        pass  # already matched or evicted


def _await_party(rv: _Rendezvous, me: _Party, deadline: float):
    """Wait until this party's pairing completes, in bounded slices (a
    counterpart revoked mid-build surfaces within one slice). A parked
    acceptor under tpurun pumps the cross-process connect channel in
    each slice. The timeout of an UNMATCHED party withdraws only itself.
    Caller holds _lock."""
    while True:
        if me.error is not None:
            raise me.error
        pr = me.pairing
        if pr is not None:
            if pr.error is not None:
                raise pr.error
            if pr.result is not None:
                server_side, client_side = pr.result
                return (server_side if me.side == "accept"
                        else client_side)
            other = (pr.connector if me.side == "accept"
                     else pr.acceptor).comm
            try:
                _check_counterpart(other, rv.port, me.side)
            except MPIError as err:
                pr.error = err
                _lock.notify_all()
                raise
        left = deadline - time.monotonic()
        if left <= 0:
            err = MPIError(ErrorCode.ERR_PORT,
                           f"{me.side} on '{rv.port}' timed out")
            if pr is None:
                _withdraw(rv, me)
            else:
                # matched but never built: poison THIS pairing, not the
                # port
                pr.error = err
            _lock.notify_all()
            raise err
        if pr is None and me.side == "accept" and _job_pidx() is not None:
            _lock.release()
            try:
                _pump_connects(min(left, 0.1))
            finally:
                _lock.acquire()
        else:
            _lock.wait(timeout=min(left, 0.2))


def open_port() -> str:
    """``MPI_Open_port``: mint an opaque port name (job-unique under
    tpurun: it names its owner process)."""
    pidx = _job_pidx()
    n = next(_port_counter)
    port = (f"{PORT_PREFIX}{n}" if pidx is None
            else f"{PORT_PREFIX}{pidx}.{n}")
    with _lock:
        _pending[port] = _Rendezvous(port)
        _opened.add(port)
    if pidx is not None:
        publish_name(_OPEN_PREFIX + port, "open")
    return port


def close_port(port: str) -> None:
    """``MPI_Close_port``: retire the port and fail every parked party
    promptly. Under tpurun the closure is recorded in the job's name
    table, so a lookup in any worker sees a dead name."""
    with _lock:
        rv = _pending.pop(port, None)
        if rv is not None:
            err = MPIError(ErrorCode.ERR_PORT, f"port '{port}' closed")
            for party in rv.acceptors + rv.connectors:
                if party.error is None and party.pairing is None:
                    party.error = err
                    if party.remote is not None:
                        _reply(party.remote, False, None, str(err))
            rv.acceptors.clear()
            rv.connectors.clear()
            _lock.notify_all()
    if rv is not None and _owner_of(port) is not None \
            and _job_pidx() is not None:
        try:
            unpublish_name(_OPEN_PREFIX + port)
        except MPIError:
            pass  # already withdrawn


def check_port(service: str, port: str) -> None:
    """The port table's lookup check: ``port`` (a value ``service``
    resolved to) names a closed ``tpu-port:`` → ``ERR_PROC_FAILED``; a
    port whose parked acceptor's comm died → the counterpart's error.
    Values that are not ports pass through, as does a ``tpu-port:`` under
    tpurun that names no process of the job (the JAX package's job
    table hands every value through)."""
    if not port.startswith(PORT_PREFIX):
        return
    with _lock:
        rv = _pending.get(port)
        mine = port in _opened
        if rv is not None:
            _check_counterpart(rv.acceptors[0].comm if rv.acceptors
                               else None, port, f"lookup '{service}'")
            return
    owner, me = _owner_of(port), _job_pidx()
    if me is not None and owner is None:
        return  # not minted under this job: an opaque value, as published
    closed = True  # opened here and closed, or never opened anywhere
    if not mine and me is not None and owner is not None and owner != me:
        # another worker's port: open while its marker is published
        try:
            _pubsub.lookup_name(_OPEN_PREFIX + port,
                                timeout_s=_MARKER_WAIT_S)
            closed = False
        except MPIError:
            pass
    if closed:
        raise MPIError(
            ErrorCode.ERR_PROC_FAILED,
            f"service '{service}' names port '{port}' which has been "
            "closed (publisher died or retired the port without "
            "unpublishing)",
        )


def lookup_name(service: str, *, timeout_s: float = 10.0) -> str:
    """``MPI_Lookup_name``: the name service's lookup (it blocks until
    the name is published or ``timeout_s`` passes: ERR_NAME), then
    :func:`check_port` on the value: a closed ``tpu-port:`` raises
    ``ERR_PROC_FAILED``, in a singleton and under tpurun alike."""
    port = _pubsub.lookup_name(service, timeout_s=timeout_s)
    check_port(service, port)
    return port


# ---------------------------------------------------------------------------
# cross-process rendezvous (tpurun)
# ---------------------------------------------------------------------------

def _ep():
    return _runtime().agent.ep


def _reply(remote: Tuple[int, int], ok: bool, group: Optional[Group],
           msg: str, cid_base: int = -1) -> None:
    pidx, token = remote
    buf = DssBuffer()
    buf.pack_string(_DPM_MAGIC)
    buf.pack_int64([token, 1 if ok else 0, cid_base])
    buf.pack_string(msg)
    ranks = list(group.world_ranks) if group is not None else []
    buf.pack_int64(len(ranks))
    if ranks:
        buf.pack_int64(ranks)
    _ep().send(pidx + 1, TAG_DPM_REPLY, buf.tobytes())


def _pump_connects(slice_s: float) -> None:
    """Pop cross-process connect requests for this process's ports and
    queue each as a remote connector party (pairing it when an acceptor
    is parked). Called without _lock held."""
    from ..btl.components import stashed_recv

    try:
        src, raw = stashed_recv(_ep(), None, TAG_DPM_CONNECT,
                                time.monotonic() + slice_s)
    except MPIError:
        return
    buf = DssBuffer(raw)
    if buf.unpack_string() != _DPM_MAGIC:
        return
    port = buf.unpack_string()
    token, epoch, n = buf.unpack_int64(3)
    ranks = [int(r) for r in buf.unpack_int64(int(n))] if n else []
    remote = (src - 1, int(token))
    party = _Party(None, "connect", group=Group(ranks), remote=remote)
    pairing = None
    with _lock:
        rv = _pending.get(port)
        if rv is None:
            _reply(remote, False, None, f"unknown port '{port}'")
            return
        if int(epoch) < rv.epoch:
            _reply(remote, False, None,
                   f"connect on '{port}': joiner epoch {epoch} is stale")
            return
        if rv.acceptors:
            cand = rv.acceptors[0]
            try:
                _check_disjoint(cand.group, party.group)
            except MPIError as err:
                _reply(remote, False, None, str(err))
                return
            rv.acceptors.pop(0)
            pairing = _Pairing(port, cand, party)
            cand.pairing = party.pairing = pairing
        else:
            rv.connectors.append(party)
        _lock.notify_all()
    if pairing is not None:
        _build_intercomm(pairing, _runtime())


def _remote_connect(comm: Communicator, port: str, owner: int,
                    timeout_s: float, epoch: int) -> Intercommunicator:
    """Connect to a port another worker owns: send the group, await the
    acceptor's group and the pair's cid block, build the same pair the
    owner builds. A block this process already uses is refused
    (ERR_PORT): the two sides' cids would not agree."""
    from ..btl.components import stashed_recv

    token = next(_token)
    buf = DssBuffer()
    buf.pack_string(_DPM_MAGIC)
    buf.pack_string(port)
    ranks = list(comm.group.world_ranks)
    buf.pack_int64([token, epoch, len(ranks)])
    buf.pack_int64(ranks)
    _ep().send(owner + 1, TAG_DPM_CONNECT, buf.tobytes())
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            _src, raw = stashed_recv(_ep(), owner + 1, TAG_DPM_REPLY,
                                     deadline)
        except MPIError:
            raise MPIError(ErrorCode.ERR_PORT,
                           f"connect on '{port}' timed out") from None
        rb = DssBuffer(raw)
        if rb.unpack_string() != _DPM_MAGIC:
            continue
        got, ok, cid_base = rb.unpack_int64(3)
        msg = rb.unpack_string()
        (n,) = rb.unpack_int64()
        acc = [int(r) for r in rb.unpack_int64(int(n))] if n else []
        if int(got) != token:
            continue  # a reply to an earlier, timed-out connect
        if not ok:
            raise MPIError(ErrorCode.ERR_PORT, msg)
        if cids_in_use(int(cid_base), DPM_CID_BLOCK):
            raise MPIError(
                ErrorCode.ERR_PORT,
                f"connect on '{port}': the owner's cid block "
                f"[{int(cid_base)}, +{DPM_CID_BLOCK}) is in use here")
        _, client_side = Intercommunicator.create(
            comm.runtime, Group(acc), comm.group,
            name=f"accept({port})",
            cid_block=CidBlock(int(cid_base), DPM_CID_BLOCK))
        return client_side


# ---------------------------------------------------------------------------
# accept / connect
# ---------------------------------------------------------------------------

def _rendezvous(comm: Communicator, port: str, side: str,
                timeout_s: float,
                epoch: Optional[int] = None) -> Intercommunicator:
    """The shared accept/connect protocol; ``side`` picks which queue
    this caller parks in and which handle of the pair it receives.
    ``epoch`` is the epoch the connector's plan was formed at (default:
    the connecting communicator's birth epoch): a joiner whose plan
    predates the port's world view is refused."""
    if epoch is None:
        epoch = getattr(comm, "_ft_epoch0", 0)
    deadline = time.monotonic() + timeout_s
    me = _Party(comm, side)
    owner = _owner_of(port)
    mine = _job_pidx()
    if (side == "connect" and owner is not None and mine is not None
            and owner != mine):
        return _remote_connect(comm, port, owner, timeout_s, epoch)
    with _lock:
        rv = _pending.get(port)
        if rv is None:
            raise MPIError(ErrorCode.ERR_PORT, f"unknown port '{port}'")
        if side == "connect" and epoch < rv.epoch:
            raise MPIError(
                ErrorCode.ERR_REVOKED,
                f"connect on '{port}': joiner epoch {epoch} is stale "
                f"(port opened at epoch {rv.epoch}) — rebuild the "
                "communicator against the current failure picture and "
                "retry",
            )
        theirs = rv.connectors if side == "accept" else rv.acceptors
        pairing = None
        if theirs:
            cand = theirs[0]
            # fast-fail on a dead parked head before pairing, and retire
            # it with the same error so its own wait wakes typed
            try:
                _check_counterpart(cand.comm, port, side)
            except MPIError as err:
                theirs.pop(0)
                cand.error = err
                _lock.notify_all()
                raise
            _check_disjoint(comm.group, cand.group)  # before dequeuing
            theirs.pop(0)
            if side == "accept":
                pairing = _Pairing(port, me, cand)
            else:
                pairing = _Pairing(port, cand, me)
            me.pairing = cand.pairing = pairing
        else:
            (rv.acceptors if side == "accept"
             else rv.connectors).append(me)
        _lock.notify_all()
    if pairing is not None:
        # the matchmaker builds its own pairing outside the lock
        _build_intercomm(pairing, comm.runtime)
    with _lock:
        return _await_party(rv, me, deadline)


def comm_accept(comm: Communicator, port: str, *,
                timeout_s: float = 30.0) -> Intercommunicator:
    """``MPI_Comm_accept``: block on ``port`` until a connector arrives
    (in this process, or under tpurun in another worker); returns this
    (server) side's intercomm handle. The port stays valid afterwards —
    a server can loop accept on one published port."""
    return _rendezvous(comm, port, "accept", timeout_s)


def comm_connect(comm: Communicator, port: str, *,
                 timeout_s: float = 30.0,
                 epoch: Optional[int] = None) -> Intercommunicator:
    """``MPI_Comm_connect``: rendezvous with the acceptor on ``port``;
    returns this (client) side's intercomm handle. ``epoch`` (default:
    the comm's birth epoch) is fenced against the port's epoch."""
    return _rendezvous(comm, port, "connect", timeout_s, epoch=epoch)


def clear() -> None:
    """Finalize-time teardown: fail parked waiters immediately, then
    drop the port table (the names live in ``runtime/pubsub.py``)."""
    with _lock:
        err = MPIError(ErrorCode.ERR_PORT, "dpm torn down (finalize)")
        for rv in _pending.values():
            for party in rv.acceptors + rv.connectors:
                if party.error is None:
                    party.error = err
        _pending.clear()
        _opened.clear()
        _lock.notify_all()
    _pubsub.clear_local()
