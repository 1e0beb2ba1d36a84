"""tpurun — the job launcher (``orterun``/``mpirun`` analogue; the
port's counterpart of ``ompi_release_tpu/tools/tpurun.py``).

Usage::

    python -m ompi_release_tpu_torch.tools.tpurun -n 4 [--mca VAR VAL]... \
        [--timeout S] prog [args...]

What the reference's ``orterun`` does (``orte/tools/orterun/orterun.c``:
build job, register state callbacks, ``orte_plm.spawn`` :1077; daemons
``orted_main.c:234`` report back; apps launch, register, run, exit;
stdio forwards through the iof) — re-shaped for one-host-many-process
and multi-host TPU jobs:

  1. start the HNP coordinator endpoint (node 0)
  2. fork N worker processes with ``OMPITPU_*`` env (the ess/env
     detection contract) + ``OMPITPU_MCA_*`` for ``--mca`` pairs
  3. serve modex + init barrier on a thread (the PLM/grpcomm role)
  4. forward each worker's stdout/stderr line-tagged ``[rank k]``
     (the iof role, ``orte/mca/iof``)
  5. monitor heartbeats (``sensor_heartbeat.c:61,78``) and process
     exits; on abnormal exit or heartbeat loss, activate the error
     state and kill the job (errmgr default_hnp policy: clean teardown)
  6. aggregate exit codes: 0 iff every worker exited 0 after FIN

The job/proc state machines are the real ``runtime/state.py`` ones, so
tests (and ``ft_tester``-style kills) can assert the exact state path
the reference defines (``plm_types.h:113-151``).

Failure policies (errmgr): ``abort`` (the default: tear the job down
on the first abnormal exit or heartbeat loss), ``restart``
(``--enable-recovery``: respawn the failed rank on a surviving slot,
rmaps/resilient; the app resumes from its checkpoint or rebuilds its
communicator through ``ft.errmgr.recover``) and ``continue``
(``--ft-continue``: the ULFM degraded world — the failed rank is
promoted through the job epoch and the survivors shrink and carry on).
``--ft-inject RANK:STEP`` arms the sensor's SIGKILL in one worker's
first incarnation. ``tpu-migrate`` moves ranks off a host of a live
job through the HNP's migrate responder; it finds the job through the
session contact file. The HNP also serves the observability plane:
``tpu_ps`` snapshots (with the launcher's proc states), the workers'
clock ping-pongs and the fleet store of their sampler pushes.
"""

from __future__ import annotations

import argparse
import os
import re
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from ..runtime import coordinator as coord
from ..runtime.state import JobState, ProcState, StateMachine
from ..utils import output
from ..utils.errors import ErrorCode, MPIError

_log = output.stream("tpurun")

_LOCAL_NAMES = ("localhost", "127.0.0.1")

#: session contact directory (the orterun session-dir analogue:
#: ``tpu-migrate`` discovers live jobs by reading the contact files
#: under the session dir)
SESSION_DIR = os.path.join(
    os.environ.get("TMPDIR", "/tmp"),
    f"ompitpu-sessions-{os.getuid()}",
)

# ---------------------------------------------------------------------------
# rmaps-lite: hostfile + rank->host mapping (orte/mca/rmaps analogue)
# ---------------------------------------------------------------------------

class HostSpec:
    """One allocation line: hostname + slot count (ras analogue)."""

    def __init__(self, name: str, slots: int = 1) -> None:
        if slots < 1:
            raise MPIError(ErrorCode.ERR_ARG,
                           f"host {name}: slots must be >= 1")
        self.name = name
        self.slots = slots

    @property
    def is_local(self) -> bool:
        return self.name in _LOCAL_NAMES

    def __repr__(self) -> str:
        return f"HostSpec({self.name}, slots={self.slots})"


def parse_hostfile(path: str) -> List[HostSpec]:
    """Hostfile lines: ``hostname [slots=N]`` (# comments allowed) —
    the mpirun hostfile format's core."""
    hosts: List[HostSpec] = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            slots = 1
            for tok in parts[1:]:
                if tok.startswith("slots="):
                    try:
                        slots = int(tok.split("=", 1)[1])
                    except ValueError:
                        raise MPIError(
                            ErrorCode.ERR_ARG,
                            f"hostfile {path}: bad slot count in "
                            f"'{line}'",
                        )
                else:
                    # 'slot=8' silently parsing as slots=1 would map
                    # ranks onto machines the user meant to keep free
                    raise MPIError(
                        ErrorCode.ERR_ARG,
                        f"hostfile {path}: unrecognized token "
                        f"'{tok}' in '{line}' (only 'slots=N' is "
                        "supported)",
                    )
            hosts.append(HostSpec(parts[0], slots))
    if not hosts:
        raise MPIError(ErrorCode.ERR_ARG, f"hostfile {path} has no hosts")
    return hosts


def parse_host_list(spec: str) -> List[HostSpec]:
    """``--host a:2,b,c:4`` (name[:slots] comma list)."""
    hosts = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        if ":" in item:
            name, slots = item.rsplit(":", 1)
            try:
                hosts.append(HostSpec(name, int(slots)))
            except ValueError:
                raise MPIError(ErrorCode.ERR_ARG,
                               f"bad slot count in '{item}'")
        else:
            hosts.append(HostSpec(item))
    if not hosts:
        raise MPIError(ErrorCode.ERR_ARG, f"empty host list '{spec}'")
    return hosts


def map_ranks(hosts: List[HostSpec], n: int,
              policy: str = "slot") -> List[HostSpec]:
    """Rank->host mapping (the rmaps framework's mapper menu).

    ``slot``: fill each host's slots before moving on (rmaps_rr
    by-slot). ``node``: round-robin one rank per host per pass
    (by-node). ``ppr:N:node``: exactly N processes per node in
    allocation order (``orte/mca/rmaps/ppr``). ``seq``: rank i runs on
    the i-th allocation LINE, slots ignored — list a host on several
    lines to stack ranks on it (``orte/mca/rmaps/seq``).
    Oversubscription (n > total slots, or ppr N > a host's slots) is
    an error, like the reference without ``--oversubscribe``.
    rank_file mapping is a separate entry point (:func:`parse_rankfile`)
    since it carries its own placement list. mindist (NUMA/NIC
    distance) has no TPU meaning — a worker owns its chips by
    construction — and is deliberately absent.
    """
    out: List[HostSpec] = []
    if policy == "seq":
        # one rank per allocation line, in file order
        if n > len(hosts):
            raise MPIError(
                ErrorCode.ERR_ARG,
                f"seq mapper: {n} ranks but only {len(hosts)} "
                "allocation lines (list a host once per rank)",
            )
        return list(hosts[:n])
    if policy.startswith("ppr:"):
        parts = policy.split(":")
        if len(parts) != 3 or parts[2] != "node":
            raise MPIError(
                ErrorCode.ERR_ARG,
                f"bad ppr spec '{policy}' (expected ppr:N:node)",
            )
        try:
            per = int(parts[1])
        except ValueError:
            per = 0
        if per < 1:
            raise MPIError(ErrorCode.ERR_ARG,
                           f"bad ppr count in '{policy}'")
        for h in hosts:
            if per > h.slots:
                raise MPIError(
                    ErrorCode.ERR_ARG,
                    f"ppr {per}/node exceeds {h.slots} slot(s) on "
                    f"{h.name} (no oversubscription)",
                )
            for _ in range(per):
                if len(out) < n:
                    out.append(h)
        if len(out) < n:
            raise MPIError(
                ErrorCode.ERR_ARG,
                f"ppr {per}/node places only "
                f"{per * len(hosts)} ranks on {len(hosts)} hosts "
                f"but {n} were requested",
            )
        return out
    total = sum(h.slots for h in hosts)
    if n > total:
        raise MPIError(
            ErrorCode.ERR_ARG,
            f"{n} ranks > {total} slots on {len(hosts)} hosts "
            "(no oversubscription)",
        )
    if policy == "slot":
        for h in hosts:
            for _ in range(h.slots):
                if len(out) < n:
                    out.append(h)
    elif policy == "node":
        used = {id(h): 0 for h in hosts}
        while len(out) < n:
            progressed = False
            for h in hosts:
                if len(out) >= n:
                    break
                if used[id(h)] < h.slots:
                    out.append(h)
                    used[id(h)] += 1
                    progressed = True
            if not progressed:  # all slots consumed (can't happen: n<=total)
                break
    else:
        raise MPIError(ErrorCode.ERR_ARG,
                       f"unknown map-by policy '{policy}'")
    return out


def parse_rankfile(path: str, n: int,
                   hosts: Optional[List[HostSpec]] = None
                   ) -> List[HostSpec]:
    """Explicit per-rank placement (``orte/mca/rmaps/rank_file``).

    Syntax, one line per rank (comments ``#``)::

        rank 3=hostB slot=1

    ``slot=`` is accepted and validated for range but carries no
    binding semantics (a TPU worker owns whole chips, not cores).
    Every rank 0..n-1 must appear exactly once. When an allocation is
    given (--hostfile/--host) every named host must be in it and its
    per-host rank count must fit its slots; without one, named hosts
    form their own allocation (one slot per placed rank)."""
    alloc = {h.name: h for h in (hosts or [])}
    placed: Dict[int, str] = {}
    counts: Dict[str, int] = {}
    try:
        lines = open(path).read().splitlines()
    except OSError as e:
        raise MPIError(ErrorCode.ERR_FILE,
                       f"cannot read rankfile {path}: {e}")
    for lineno, line in enumerate(lines, 1):
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        m = re.match(r"rank\s+(\d+)\s*=\s*(\S+?)"
                     r"(?:\s+slot\s*=\s*(\d+))?\s*$", line)
        if not m:
            raise MPIError(
                ErrorCode.ERR_ARG,
                f"rankfile {path}:{lineno}: unparseable line "
                f"'{line}' (expected 'rank N=host [slot=S]')",
            )
        r, host, slot = int(m.group(1)), m.group(2), m.group(3)
        if r in placed:
            raise MPIError(ErrorCode.ERR_ARG,
                           f"rankfile {path}:{lineno}: rank {r} "
                           "placed twice")
        if r >= n:
            raise MPIError(ErrorCode.ERR_ARG,
                           f"rankfile {path}:{lineno}: rank {r} out "
                           f"of range for -n {n}")
        if alloc and host not in alloc:
            raise MPIError(
                ErrorCode.ERR_ARG,
                f"rankfile {path}:{lineno}: host '{host}' not in "
                f"the allocation ({', '.join(sorted(alloc))})",
            )
        if slot is not None and alloc and int(slot) >= alloc[host].slots:
            raise MPIError(
                ErrorCode.ERR_ARG,
                f"rankfile {path}:{lineno}: slot {slot} out of range "
                f"on {host} ({alloc[host].slots} slots)",
            )
        placed[r] = host
        counts[host] = counts.get(host, 0) + 1
    missing = [r for r in range(n) if r not in placed]
    if missing:
        raise MPIError(
            ErrorCode.ERR_ARG,
            f"rankfile {path} leaves rank(s) "
            f"{', '.join(map(str, missing))} unmapped for -n {n}",
        )
    for host, c in counts.items():
        if alloc and c > alloc[host].slots:
            raise MPIError(
                ErrorCode.ERR_ARG,
                f"rankfile {path}: {c} ranks on {host} exceed its "
                f"{alloc[host].slots} slot(s) (no oversubscription)",
            )
    by_name = alloc or {h: HostSpec(h, counts[h]) for h in counts}
    return [by_name[placed[r]] for r in range(n)]


class Job:
    """One launched job: processes + coordinator + state machines."""

    def __init__(self, num_procs: int, argv: List[str],
                 mca: List[tuple], *, heartbeat_s: float = 0.5,
                 miss_limit: int = 4, tag_output: bool = True,
                 hosts: Optional[List[HostSpec]] = None,
                 map_by: str = "slot",
                 rankfile: Optional[str] = None,
                 launch_agent: str = "ssh",
                 on_failure: str = "abort",
                 max_restarts: int = 2,
                 ft_inject: Optional[tuple] = None) -> None:
        self.n = num_procs
        self.argv = argv
        self.mca = mca
        self.heartbeat_s = heartbeat_s
        self.miss_limit = miss_limit
        self.tag_output = tag_output
        # rmaps: rank r runs on rank_hosts[r] (default: all-local,
        # the single-host fork path); an explicit rankfile overrides
        # the policy mapper (rank_file has top rmaps priority in the
        # reference too)
        self.hosts = hosts or [HostSpec("localhost", num_procs)]
        if rankfile is not None:
            self.rank_hosts = parse_rankfile(rankfile, num_procs, hosts)
            if hosts is None:
                # the rankfile's named hosts ARE the allocation: the
                # remapper/migrator key host load by identity over
                # self.hosts, so the phantom localhost spec must not
                # survive (parse_rankfile reuses one HostSpec per
                # name, so dedup by id works)
                seen: Dict[int, HostSpec] = {}
                for h in self.rank_hosts:
                    seen.setdefault(id(h), h)
                self.hosts = list(seen.values())
        else:
            self.rank_hosts = map_ranks(self.hosts, num_procs, map_by)
        self.remote = any(not h.is_local for h in self.rank_hosts)
        self.launch_agent = launch_agent
        # errmgr policy: 'abort' = default_hnp teardown; 'restart' =
        # rmaps/resilient respawn of the failed rank on a surviving
        # slot (the app resumes from its last committed checkpoint);
        # 'continue' = the ULFM degraded world — the failed rank is
        # promoted through the job epoch (TAG_PROC_FAILED) and the
        # survivors keep running (they shrink and carry on); the job
        # exits 0 iff every SURVIVOR finished clean
        if on_failure not in ("abort", "restart", "continue"):
            raise MPIError(ErrorCode.ERR_ARG,
                           f"unknown failure policy '{on_failure}'")
        self.on_failure = on_failure
        self.max_restarts = max_restarts
        # chaos injection (--ft-inject rank:step): arm the sensor's
        # hard kill in EXACTLY the chosen child via its env cvars
        if ft_inject is not None:
            r, s = int(ft_inject[0]), int(ft_inject[1])
            if not 0 <= r < num_procs:
                raise MPIError(ErrorCode.ERR_ARG,
                               f"--ft-inject rank {r} out of range "
                               f"for -n {num_procs}")
            if s < 0:
                raise MPIError(ErrorCode.ERR_ARG,
                               f"--ft-inject step {s} must be >= 0")
            ft_inject = (r, s)
        self.ft_inject = ft_inject
        #: node ids promoted to failed under the 'continue' policy:
        #: their exit codes never fail the job, and the FIN collector
        #: stops expecting them
        self._ft_failed_ranks: set = set()
        self._restarts: Dict[int, int] = {}
        self._respawned: List[int] = []  # drained by the waitpid loop
        self._restarting: set = set()    # ranks mid-respawn (dedupe)
        self._respawn_lock = threading.Lock()
        self.job_state = StateMachine("tpurun-job")
        self.proc_state: Dict[int, int] = {}
        self.hnp: Optional[coord.HnpCoordinator] = None
        self.hnp_host = "127.0.0.1"
        self.procs: Dict[int, subprocess.Popen] = {}
        self._iof_threads: List[threading.Thread] = []
        self._failed = threading.Event()
        self._fin: set = set()
        self._fin_lock = threading.Lock()
        #: every pid a local rank ran under, respawned incarnations
        #: included: their shm segments and rings are reaped at job end
        self._local_pids: set = set()
        # hosts evacuated by tpu-migrate: the remapper never places a
        # rank (migrated OR failure-respawned) back on one of these
        self._excluded_hosts: set = set()
        # serializes rank_hosts read-modify-write: concurrent moves
        # (multi-rank migration, or migration racing a failure
        # restart) must each see the other's placement or two ranks
        # can double-book one free slot
        self._map_lock = threading.Lock()
        # per-job control-plane secret (opal/mca/sec analogue): the
        # HNP endpoint picks it up from the environment, every worker
        # inherits it (fork env / the rsh env assignments), and the
        # OOB refuses unauthenticated inbound connections — a foreign
        # local process can no longer inject TAG_DIE/TAG_MIGRATE
        import secrets as _secrets

        from ..native.bindings import SECRET_ENV

        self.secret = os.environ.get(SECRET_ENV) or _secrets.token_hex(16)
        os.environ[SECRET_ENV] = self.secret

    # -- launch ------------------------------------------------------------
    def _env_for(self, node_id: int) -> Dict[str, str]:
        env = dict(os.environ)
        env.update(self._ompitpu_env(node_id))
        return env

    def _ompitpu_env(self, node_id: int) -> Dict[str, str]:
        """The contract env vars alone — what an rsh launch must carry
        across the wire (ssh does not forward the environment; the
        reference builds them into the orted command line,
        plm_rsh_module.c:872)."""
        env = {
            "OMPITPU_JOB_SECRET": self.secret,
            "OMPITPU_HNP": f"{self.hnp_host}:{self.hnp.port}",
            "OMPITPU_NODE_ID": str(node_id),
            "OMPITPU_NUM_NODES": str(self.n),
            "OMPITPU_HOST": self.rank_hosts[node_id - 1].name,
            "OMPITPU_MCA_ess_tpurun_heartbeat_interval": str(
                self.heartbeat_s
            ),
        }
        if self.on_failure == "restart":
            # workers under the resilient policy tolerate unreachable
            # peers at wire-up (a peer may be mid-restart or finished)
            env["OMPITPU_RECOVERY"] = "1"
        if self._restarts.get(node_id, 0):
            # authoritative incarnation marker: a RESPAWNED process
            # knows it is a replacement without racing the failure
            # picture (the rejoin epoch bump can land before or after
            # any point the app samples it — the env cannot)
            env["OMPITPU_INCARNATION"] = str(self._restarts[node_id])
        if self.ft_inject is not None and node_id - 1 == self.ft_inject[0] \
                and not self._restarts.get(node_id, 0):
            # chaos: arm the sensor's SIGKILL at the chosen step in
            # THIS child only (FtTester.from_cvars reads it) — and
            # only in the FIRST incarnation: --ft-inject injects ONE
            # failure, so a respawned replacement must not re-kill
            # itself at the same step
            env["OMPITPU_MCA_sensor_ft_kill_step"] = str(
                self.ft_inject[1])
        for k, v in self.mca:
            env[f"OMPITPU_MCA_{k}"] = str(v)
        return env

    def _iof(self, node_id: int, stream, out) -> None:
        """Forward one worker stream, line-tagged (iof analogue)."""
        prefix = f"[rank {node_id - 1}] " if self.tag_output else ""
        for line in stream:
            out.write(prefix + line)
            out.flush()

    def _spawn(self, node_id: int) -> None:
        host = self.rank_hosts[node_id - 1]
        secret_on_stdin = False
        if host.is_local:
            cmd = self.argv
            env = self._env_for(node_id)
        else:
            # rsh launch (plm_rsh_module.c:929): agent + host + env
            # assignments + program. ssh joins the args and hands ONE
            # string to the remote shell, so every word is quoted
            # (the reference's plm_rsh quotes its orted cmdline too).
            # The JOB SECRET must NOT ride the command line (visible to
            # every local user via /proc/*/cmdline on both machines —
            # defeating the auth it feeds); it travels on the worker's
            # stdin instead, announced by OMPITPU_SECRET_STDIN
            import shlex

            wire_env = dict(self._ompitpu_env(node_id))
            wire_env.pop("OMPITPU_JOB_SECRET", None)
            wire_env["OMPITPU_SECRET_STDIN"] = "1"
            cmd = (
                self.launch_agent.split()
                + [host.name, "env"]
                + [shlex.quote(f"{k}={v}") for k, v in
                   sorted(wire_env.items())]
                + [shlex.quote(a) for a in self.argv]
            )
            env = dict(os.environ)
            secret_on_stdin = True
        p = subprocess.Popen(
            cmd, env=env,
            stdin=subprocess.PIPE if secret_on_stdin else None,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, bufsize=1,
        )
        if secret_on_stdin:
            try:
                p.stdin.write(self.secret + "\n")
                p.stdin.flush()
            except OSError:
                pass  # a dead child surfaces through the waitpid loop
        self.procs[node_id] = p
        if host.is_local:
            self._local_pids.add(p.pid)
        self.proc_state[node_id] = ProcState.RUNNING
        for stream, out in ((p.stdout, sys.stdout), (p.stderr, sys.stderr)):
            t = threading.Thread(
                target=self._iof, args=(node_id, stream, out), daemon=True
            )
            t.start()
            self._iof_threads.append(t)

    # -- failure policy (errmgr default_hnp teardown / resilient) ----------
    def _on_worker_failure(self, node_id: int, state: int) -> None:
        self.proc_state[node_id] = state
        if self._failed.is_set():
            return
        if self.on_failure == "continue" and self.job_state.visited(
                JobState.RUNNING):
            # ULFM degraded world (only once the job is RUNNING — a
            # child that dies during bring-up must abort the launch
            # loudly, like the restart policy's guard, or survivors
            # would park in wire-up masking the real startup error):
            # promote through the job epoch (the
            # waitpid loop usually observes the corpse long before the
            # heartbeat window closes — promote_failed is idempotent
            # with the monitor's own promotion) and keep running; the
            # survivors revoke/shrink and carry on
            with self._fin_lock:
                first = node_id not in self._ft_failed_ranks
                if first:
                    self._ft_failed_ranks.add(node_id)
            if first:
                try:
                    self.hnp.promote_failed(node_id)
                except MPIError:
                    pass  # links torn down at job end
                # a WEDGED worker (heartbeat-promoted, process still
                # alive) must be reaped or the waitpid loop would spin
                # to the job timeout: control-plane kill first (the
                # odls path that reaches ssh-launched workers), then
                # SIGKILL the local handle — the rc<0 signal death is
                # exactly what the exit-code policy excuses
                p = self.procs.get(node_id)
                if p is not None and p.poll() is None:
                    try:
                        self.hnp.kill_worker(node_id)
                    except MPIError:
                        pass
                    try:
                        p.wait(timeout=1)
                    except subprocess.TimeoutExpired:
                        pass
                    if p.poll() is None:
                        p.kill()
                _log.verbose(
                    0, f"worker {node_id} failed "
                       f"({ProcState(state).name}); continuing "
                       "degraded (--ft-continue)")
            return
        if self.on_failure == "restart" and self.job_state.visited(
                JobState.RUNNING):
            # one restart per failure: the heartbeat monitor and the
            # waitpid loop can BOTH observe the same dead incarnation —
            # the budget is read-modify-written and deduped under the
            # lock, and the (slow: terminate+wait+spawn) respawn runs
            # off-thread so the monitor keeps draining beats
            with self._respawn_lock:
                if node_id in self._restarting:
                    return  # the other observer is already handling it
                used = self._restarts.get(node_id, 0)
                granted = used < self.max_restarts
                if granted:
                    self._restarts[node_id] = used + 1
                    self._restarting.add(node_id)
            if granted:
                # promote through the job epoch FIRST: survivors'
                # bounded waits must raise ERR_PROC_FAILED and enter
                # recovery while the (slow) respawn runs; the respawn
                # path's note_restarted then moves the rank from
                # failed to restarted at the next epoch
                try:
                    self.hnp.promote_failed(node_id)
                except MPIError:
                    pass
                threading.Thread(
                    target=self._restart_rank, args=(node_id, state),
                    daemon=True,
                ).start()
                return
            _log.verbose(1, f"worker {node_id}: restart budget "
                            f"({self.max_restarts}) exhausted")
        self._failed.set()
        self.job_state.activate(JobState.ABORTED, {"node": node_id,
                                                   "state": int(state)})
        _log.verbose(1, f"worker {node_id} failed "
                        f"({ProcState(state).name}); tearing down")
        self.terminate()

    def _remap_rank(self, node_id: int) -> None:
        """rmaps/resilient remap: move the failed rank to the
        least-loaded surviving slot, preferring a DIFFERENT host when
        one exists (``rmaps_resilient.c``'s move-off-the-fault-node
        policy; on a single-host allocation the same host is the only
        slot pool)."""
        with self._map_lock:
            failed_host = self.rank_hosts[node_id - 1]
            load: Dict[int, int] = {id(h): 0 for h in self.hosts}
            for i, h in enumerate(self.rank_hosts):
                if i != node_id - 1:
                    load[id(h)] += 1
            candidates = sorted(
                (h for h in self.hosts
                 if h.slots - load[id(h)] > 0
                 and h.name not in self._excluded_hosts),
                key=lambda h: (h.name == failed_host.name, load[id(h)]),
            )
            if candidates:
                self.rank_hosts[node_id - 1] = candidates[0]
            elif failed_host.name in self._excluded_hosts:
                # nowhere to put an evacuated rank: surface rather
                # than silently respawning on the host being drained
                raise MPIError(
                    ErrorCode.ERR_UNREACH,
                    f"no surviving slot for rank {node_id - 1} off "
                    f"evacuated host {failed_host.name}",
                )

    def _restart_rank(self, node_id: int, state: int) -> None:
        """Respawn the failed rank (same node id = same rank identity;
        the rejoin service re-runs its wire-up) and hand it back to
        the waitpid loop. The app's own checkpoint/restore logic
        (ft.run_with_restart / Checkpointer) resumes its work."""
        _log.verbose(
            0, f"worker {node_id} failed ({ProcState(state).name}); "
               f"restarting (attempt "
               f"{self._restarts[node_id]}/{self.max_restarts})")
        self._move_rank(node_id, f"respawn of worker {node_id}")

    def _move_rank(self, node_id: int, what: str) -> None:
        """Terminate the rank's current incarnation, remap it to a
        surviving slot, respawn it. Caller must already hold the
        rank in ``_restarting`` (that flag is what stops the waitpid
        loop and heartbeat monitor from treating the deliberate
        terminate as a new failure)."""
        try:
            old = self.procs.get(node_id)
            if old is not None and old.poll() is None:
                # kill through the control plane FIRST: under an ssh
                # launch, procs[nid] is the LOCAL ssh client —
                # terminating it orphans the remote worker, which
                # then runs to completion on the host being drained.
                # TAG_DIE reaches the worker itself (odls kill); the
                # signal path below stays as the fallback for workers
                # that died before wiring up their die watcher.
                try:
                    self.hnp.kill_worker(node_id)
                    old.wait(timeout=3)
                except (MPIError, subprocess.TimeoutExpired):
                    pass
            if old is not None and old.poll() is None:
                old.terminate()
                try:
                    old.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    old.kill()
            self._remap_rank(node_id)
            if self.rank_hosts[node_id - 1].name in self._excluded_hosts:
                # this move's placement raced a concurrent evacuation
                # (its remap ran before the exclusion landed): place
                # again now that the exclusion is visible
                self._remap_rank(node_id)
            self.hnp.note_restarted(node_id)
            self._spawn(node_id)
        except Exception as exc:
            # a failed respawn (Popen error, dead launch agent) must
            # abort the job promptly, not spin the waitpid loop until
            # the wall-clock timeout with the rank parked mid-respawn
            with self._respawn_lock:
                self._restarting.discard(node_id)
            _log.verbose(0, f"{what} failed: {exc}; aborting job")
            self.abort(f"{what} failed")
            return
        with self._respawn_lock:
            self._respawned.append(node_id)
            self._restarting.discard(node_id)

    # -- proactive migration (orte-migrate analogue) -----------------------
    def migrate_off(self, req: Dict) -> Dict:
        """Evacuate every rank currently mapped to ``req['off']``:
        mark the host excluded, then move each rank through the same
        terminate->remap->respawn path the resilient errmgr uses (the
        ``orte-migrate`` + ``rmaps/resilient`` composition; reference
        ``orte/tools/orte-migrate/orte-migrate.c``). Each moved app
        resumes from its last COMMITTED checkpoint — the same
        restart-from-checkpoint contract as failure recovery; there is
        no pre-migration snapshot barrier, so work since the last
        commit is recomputed (documented, not hidden).

        Does not touch the per-rank failure-restart budget: an
        operator-requested move is not a failure."""
        off = req.get("off")
        if not off:
            return {"ok": False, "error": "missing 'off' host"}
        if self.on_failure != "restart":
            # without the recovery machinery (rejoin service,
            # OMPITPU_RECOVERY env) a respawned incarnation can never
            # rejoin — accepting would kill a rank and hang the job
            return {"ok": False,
                    "error": "job launched without --enable-recovery; "
                             "migration needs the rejoin service"}
        if self.job_state.current != int(JobState.RUNNING) or \
                self._failed.is_set():
            # CURRENT state, not visited(): a request landing after
            # completion must not spawn an unreaped stray worker
            return {"ok": False, "error": "job is not running"}
        with self._map_lock:  # consistent placement snapshot
            targets = [i + 1 for i, h in enumerate(self.rank_hosts)
                       if h.name == off]
            if not targets:
                return {"ok": False,
                        "error": f"no ranks mapped to host '{off}'"}
            # capacity check BEFORE evacuating: surviving slots must
            # absorb every moved rank or the request is refused whole
            self._excluded_hosts.add(off)
            free = sum(h.slots for h in self.hosts
                       if h.name not in self._excluded_hosts)
            staying = sum(1 for h in self.rank_hosts
                          if h.name not in self._excluded_hosts)
            if free - staying < len(targets):
                self._excluded_hosts.discard(off)
                return {"ok": False,
                        "error": f"cannot evacuate {off}: "
                                 f"{len(targets)} rank(s) need slots "
                                 f"but only {free - staying} remain "
                                 "free"}
        moved = []
        skipped = []
        for nid in targets:
            with self._respawn_lock:
                if nid in self._restarting:
                    # already mid-move (failure respawn in flight) —
                    # its placement may predate the exclusion, so the
                    # mover rechecks before spawning; still REPORT it
                    # so the operator knows this rank was not handled
                    # by this request
                    skipped.append(nid - 1)
                    continue
                self._restarting.add(nid)
            threading.Thread(
                target=self._move_rank,
                args=(nid, f"migration of worker {nid} off {off}"),
                daemon=True,
            ).start()
            moved.append(nid - 1)
        _log.verbose(0, f"migrating rank(s) "
                        f"{', '.join(map(str, moved))} off {off}")
        reply = {"ok": True, "off": off, "ranks": moved}
        if skipped:
            reply["skipped"] = skipped
            reply["note"] = ("skipped rank(s) were mid-respawn; "
                             "verify placement with tpu-ps")
        return reply

    def abort(self, reason: str = "aborted") -> None:
        """Public abort: the errmgr teardown path with state-machine
        bookkeeping (external callers must not poke _failed)."""
        if not self._failed.is_set():
            self._failed.set()
            self.job_state.activate(JobState.ABORTED, reason)
        self.terminate()

    def terminate(self) -> None:
        # control-plane kill first (odls kill): under ssh launches the
        # Popen handles are local ssh clients and signaling them would
        # orphan the remote workers (they'd run on after the job died)
        if self.hnp is not None:
            for nid, p in self.procs.items():
                if p.poll() is None:
                    try:
                        self.hnp.kill_worker(nid)
                    except MPIError:
                        pass  # never wired up / link gone: signal path
            deadline = time.monotonic() + 2
            for p in self.procs.values():
                left = deadline - time.monotonic()
                if left <= 0 or p.poll() is not None:
                    continue
                try:
                    p.wait(timeout=left)
                except subprocess.TimeoutExpired:
                    pass
        for nid, p in self.procs.items():
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + 5
        for p in self.procs.values():
            left = max(0.1, deadline - time.monotonic())
            try:
                p.wait(timeout=left)
            except subprocess.TimeoutExpired:
                p.kill()

    # -- ps/top support ----------------------------------------------------
    def _ps_extra(self) -> Dict:
        """Launcher-side snapshot fields merged into the HNP's TAG_PS
        reply: proc states + the job identity."""
        from ..runtime.state import ProcState as _PS

        return {
            "pid": os.getpid(),
            "argv": self.argv,
            "proc_states": {
                str(nid): _PS(int(s)).name
                for nid, s in self.proc_state.items()
            },
        }

    def _write_contact_file(self) -> None:
        import json

        try:
            os.makedirs(SESSION_DIR, mode=0o700, exist_ok=True)
            self._contact_path = os.path.join(
                SESSION_DIR, f"{os.getpid()}.json"
            )
            # the contact file carries the job secret so same-user
            # tools (tpu-migrate) can authenticate — 0600, like the
            # reference's session-dir contact files
            fd = os.open(self._contact_path,
                         os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
            with os.fdopen(fd, "w") as f:
                json.dump({
                    "pid": os.getpid(),
                    "host": self.hnp_host,
                    "port": self.hnp.port,
                    "n": self.n,
                    "argv": self.argv,
                    "started": time.time(),
                    "secret": self.secret,
                }, f)
        except OSError as e:
            _log.verbose(1, f"could not write contact file: {e}")
            self._contact_path = None

    def _remove_contact_file(self) -> None:
        path = getattr(self, "_contact_path", None)
        if path:
            try:
                os.unlink(path)
            except OSError:
                pass

    def _reap_segments(self) -> None:
        """Unlink the shm handoff segments and nativewire rings the
        job's local workers left (a worker that died between a peer's
        handoff and its receive, or an aborted job killed before its
        rings were released): every segment is named ``ompitpu-<creator
        pid>-…`` (``btl/components.py``), every ring ``onw-<owner pid in
        hex>-…`` (``btl/nativewire.py`` ``_ring_name``), and once the
        job has ended none of its workers' segments or rings can still
        be in flight — the orte-clean duty, run at every job end. Every
        pid a local rank ran under counts: a respawned rank's dead
        incarnations left theirs too."""
        import glob

        live = {p.pid for p in self.procs.values() if p.poll() is None}
        for pid in sorted(self._local_pids - live):
            for path in (glob.glob(f"/dev/shm/ompitpu-{pid}-*")
                         + glob.glob(f"/dev/shm/onw-{pid:x}-*")):
                try:
                    os.unlink(path)
                except FileNotFoundError:
                    pass

    # -- run ---------------------------------------------------------------
    def run(self, timeout_s: float = 300.0) -> int:
        self.job_state.activate(JobState.INIT)
        if self.remote:
            # remote workers must dial back: listen on every
            # interface and advertise the outbound address toward the
            # first remote host (the reference's HNP URI)
            first_remote = next(
                h for h in self.rank_hosts if not h.is_local
            )
            self.hnp_host = coord.local_addr_toward(first_remote.name)
            if self.hnp_host.startswith("127."):
                # loopback is only correct when the "remote" host IS
                # this machine (fake-agent tests); a genuinely remote
                # worker handed 127.0.0.1 would dial itself and the
                # job would hang to the timeout with no clue — warn
                # loudly now, while the cause is still visible
                _log.verbose(
                    0, f"WARNING: no route toward {first_remote.name}; "
                       f"advertising loopback HNP address — remote "
                       f"workers will not reach it unless "
                       f"{first_remote.name} resolves to this machine")
            self.hnp = coord.HnpCoordinator(self.n + 1,
                                            bind_addr="0.0.0.0")
        else:
            self.hnp = coord.HnpCoordinator(self.n + 1)
        self.job_state.activate(JobState.LAUNCH_DAEMONS)
        for nid in range(1, self.n + 1):
            self._spawn(nid)
        self.job_state.activate(JobState.LAUNCH_APPS)

        # PLM/grpcomm service thread: modex + init barrier, then
        # heartbeat monitoring + FIN collection
        def serve() -> None:
            try:
                cards = self.hnp.run_modex(
                    None, timeout_ms=int(timeout_s * 1000))
                self.job_state.activate(JobState.DAEMONS_REPORTED)
                self.hnp.barrier(timeout_ms=int(timeout_s * 1000))
                self.job_state.activate(JobState.RUNNING)
            except Exception as e:
                if not self._failed.is_set():
                    _log.verbose(1, f"wire-up failed: {e}")
                    self.job_state.activate(JobState.FAILED_TO_START, e)
                    self._failed.set()
                    self.terminate()
                return
            self.hnp.start_heartbeat_monitor(
                lambda nid: self._on_worker_failure(
                    nid, ProcState.HEARTBEAT_FAILED
                ),
                interval_s=self.heartbeat_s, miss_limit=self.miss_limit,
            )
            # pubsub name service (MPI_Publish_name/Lookup_name over
            # the lifeline — the orte-server role lives in the HNP)
            self.hnp.start_name_server()
            # ps/top snapshot service + session contact file so tpu-ps
            # can discover and query this live job (orte-ps role)
            self.hnp.start_ps_responder(self._ps_extra)
            self.hnp.start_migrate_responder(self.migrate_off)
            # clock ping-pong responder: workers estimate their
            # perf_counter offset to OUR clock, so tpu-doctor can merge
            # per-rank journals onto one timeline
            self.hnp.start_clock_responder()
            # fleet series store: workers push continuous pvar deltas
            # (obs_sample_interval), which the doctor merges
            self.hnp.start_series_responder()
            # ULFM plane: failure-state queries + fault-tolerant
            # agreements (shrink's survivor-group consensus) — always
            # on; costs one idle thread when the app never asks
            self.hnp.start_ft_responder()
            self._write_contact_file()
            if self.on_failure == "restart":
                # a respawned worker re-runs its full ESS wire-up
                # against the live job (JOIN + init barrier)
                self.hnp.start_rejoin_service(cards)

            def _done_count() -> int:
                with self._fin_lock:  # _ft_failed_ranks mutates on
                    #                   the monitor/waitpid threads
                    return len(self._fin | self._ft_failed_ranks)

            while not self._failed.is_set() and _done_count() < self.n:
                nid = self.hnp.recv_fin(timeout_ms=200)
                if nid is not None:
                    with self._fin_lock:
                        self._fin.add(nid)
                    self.proc_state[nid] = ProcState.IOF_COMPLETE

        server = threading.Thread(target=serve, daemon=True)
        server.start()

        # waitpid loop (odls wait_local_proc analogue)
        deadline = time.monotonic() + timeout_s
        exit_codes: Dict[int, int] = {}
        pending = set(self.procs)
        # rc==0 workers whose FIN frame hasn't been drained yet: the
        # serve thread processes TAG_FIN on a bounded recv granularity,
        # so a clean exit can be observed by waitpid before its FIN is
        # seen. Give each such worker one heartbeat interval of grace
        # before declaring LIFELINE_LOST.
        grace: Dict[int, float] = {}

        def respawn_pending() -> bool:
            with self._respawn_lock:
                return bool(self._respawned or self._restarting)

        while ((pending or grace or respawn_pending())
               and time.monotonic() < deadline):
            # respawned ranks re-enter the waitpid loop (their failed
            # incarnation's exit code no longer counts)
            with self._respawn_lock:
                respawned, self._respawned = self._respawned, []
            for nid in respawned:
                pending.add(nid)
                exit_codes.pop(nid, None)
                grace.pop(nid, None)
            with self._respawn_lock:
                restarting = set(self._restarting)
            for nid in list(pending):
                if nid in restarting:
                    continue  # mid-respawn: the new proc is coming
                rc = self.procs[nid].poll()
                if rc is None:
                    continue
                pending.discard(nid)
                exit_codes[nid] = rc
                with self._fin_lock:
                    clean = nid in self._fin
                if clean:
                    # no more beats expected. ONLY once FIN confirmed:
                    # any death — nonzero, signal, or exit-0 with no
                    # FIN (lifeline lost) — must reach
                    # _on_worker_failure BEFORE any finished mark, or
                    # promote_failed would mistake the corpse for a
                    # cleanly-finished worker and never bump the epoch
                    self.hnp.note_finished(nid)
                if rc == 0 and clean:
                    self.proc_state[nid] = ProcState.TERMINATED
                elif rc != 0:
                    if not self._failed.is_set():
                        # died with nonzero code (errmgr_default_orted.c
                        # :252 analogue)
                        self._on_worker_failure(nid, ProcState.ABORTED)
                else:
                    grace[nid] = (time.monotonic()
                                  + max(self.heartbeat_s, 0.25))
            for nid in list(grace):
                with self._fin_lock:
                    clean = nid in self._fin
                if clean:
                    self.hnp.note_finished(nid)  # FIN confirmed late
                    self.proc_state[nid] = ProcState.TERMINATED
                    del grace[nid]
                elif time.monotonic() > grace[nid]:
                    del grace[nid]
                    if not self._failed.is_set():
                        # exited 0 but never sent FIN: lifeline lost
                        self._on_worker_failure(
                            nid, ProcState.LIFELINE_LOST)
            time.sleep(0.02)

        for nid in grace:  # deadline hit while still in grace
            if not self._failed.is_set():
                self._on_worker_failure(nid, ProcState.LIFELINE_LOST)

        if pending:  # timeout
            self.job_state.activate(JobState.ABORTED, "timeout")
            self._failed.set()
            self.terminate()
            for nid in pending:
                exit_codes[nid] = self.procs[nid].poll() or 124

        server.join(timeout=5)
        self._remove_contact_file()
        self.hnp.shutdown()
        for t in self._iof_threads:
            t.join(timeout=2)
        self._reap_segments()

        if self._failed.is_set():
            rc = next((c for c in exit_codes.values() if c), 1)
            return rc
        # a nonzero code can linger without _failed when a restart was
        # granted but its respawn never cleanly completed — that is a
        # failure, not success. Ranks promoted under the 'continue'
        # policy are the exception — their death is the EXPECTED event
        # the survivors recovered from — but ONLY signal deaths (rc<0:
        # SIGKILL'd by the fault, or job-end terminate of a wedged
        # proc): a promoted rank that exited with a nonzero CODE is an
        # app crash (e.g. a survivor whose recovery failed) and must
        # fail the job.
        leftover = next(
            (c for nid, c in exit_codes.items()
             if c and not (nid in self._ft_failed_ranks and c < 0)), 0)
        if leftover:
            self.job_state.activate(JobState.ABORTED, "nonzero exit")
            return leftover
        self.job_state.activate(JobState.TERMINATED)
        return 0


def run_loopback_app(nprocs: int, app_src: str, env: dict,
                     out_path: str, *, timeout_s: int = 300,
                     mca: Optional[List[tuple]] = None,
                     job_kw: Optional[Dict] = None):
    """Spawn ``app_src`` as an ``nprocs``-process loopback Job with
    ``env`` exported for the workers, and return the JSON document the
    app wrote to ``out_path`` (or None on failure). The shared harness
    behind the bench micro-suites and the tpu-tune sweeps — the
    tempdir/env-snapshot/Job/read-results dance lives exactly once.

    Note: mutates ``os.environ`` for the spawn window (workers inherit
    the parent environment) and restores it in a finally — callers
    must not run concurrent spawns from other threads."""
    import json as _json
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        app = os.path.join(td, "loopback_app.py")
        with open(app, "w") as f:
            f.write(app_src)
        resolved_out = os.path.join(td, out_path)
        env_keep = dict(os.environ)
        os.environ.update({k: str(v) for k, v in env.items()})
        os.environ["OMPITPU_LOOPBACK_OUT"] = resolved_out
        try:
            kw = dict(heartbeat_s=0.5, miss_limit=8)
            kw.update(job_kw or {})
            job = Job(nprocs, [sys.executable, app], list(mca or ()),
                      **kw)
            rc = job.run(timeout_s=timeout_s)
        finally:
            os.environ.clear()
            os.environ.update(env_keep)
        if rc != 0 or not os.path.exists(resolved_out):
            return None
        with open(resolved_out) as f:
            return _json.load(f)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpurun", description="Launch an N-process tpu job "
        "(orterun analogue)")
    ap.add_argument("-n", "--np", type=int, required=True,
                    help="number of worker processes")
    ap.add_argument("--mca", nargs=2, action="append", default=[],
                    metavar=("VAR", "VAL"),
                    help="set an MCA variable for every worker")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="job wall-clock limit in seconds")
    ap.add_argument("--heartbeat", type=float, default=0.5,
                    help="worker heartbeat interval in seconds")
    ap.add_argument("--no-tag-output", action="store_true",
                    help="do not prefix forwarded stdio with [rank k]")
    ap.add_argument("--hostfile", default=None,
                    help="allocation file: 'hostname [slots=N]' lines")
    ap.add_argument("--host", default=None,
                    help="comma host list 'a:2,b,c:4' (name[:slots])")
    ap.add_argument("--map-by", default="slot",
                    help="rank->host policy: slot | node | seq | "
                         "ppr:N:node (rmaps round_robin/seq/ppr "
                         "analogues)")
    ap.add_argument("--rankfile", default=None,
                    help="explicit per-rank placement file "
                         "('rank N=host [slot=S]' lines; overrides "
                         "--map-by, rmaps rank_file analogue)")
    ap.add_argument("--launch-agent", default="ssh",
                    help="remote launch command (plm_rsh agent)")
    ap.add_argument("--enable-recovery", action="store_true",
                    help="restart a failed rank on a surviving slot "
                         "instead of aborting the job "
                         "(rmaps/resilient + errmgr recovery)")
    ap.add_argument("--max-restarts", type=int, default=2,
                    help="per-rank restart budget with "
                         "--enable-recovery")
    ap.add_argument("--ft-continue", action="store_true",
                    help="ULFM degraded-world policy: on a rank "
                         "failure, bump the job epoch and xcast "
                         "TAG_PROC_FAILED but keep the job running — "
                         "survivors revoke()/shrink() and continue; "
                         "exit 0 iff every survivor finishes clean "
                         "(mutually exclusive with --enable-recovery)")
    ap.add_argument("--ft-inject", default=None, metavar="RANK:STEP",
                    help="chaos mode: arm the ft sensor's SIGKILL in "
                         "worker RANK at training step STEP (exports "
                         "OMPITPU_MCA_sensor_ft_kill_step into that "
                         "child only; the app's ElasticStep/FtTester "
                         ".step() clock fires it) — used by the "
                         "recovery job tests and chaos runs")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="program and arguments to launch")
    args = ap.parse_args(argv)
    if not args.command:
        ap.error("no command given")
    if args.np < 1:
        ap.error("-n must be >= 1")
    if args.hostfile and args.host:
        ap.error("--hostfile and --host are mutually exclusive")
    if args.enable_recovery and args.ft_continue:
        ap.error("--enable-recovery and --ft-continue are mutually "
                 "exclusive (respawn vs degraded-world policy)")
    ft_inject = None
    if args.ft_inject:
        try:
            r, s = args.ft_inject.split(":", 1)
            ft_inject = (int(r), int(s))
        except ValueError:
            ap.error(f"--ft-inject expects RANK:STEP, got "
                     f"'{args.ft_inject}'")
    hosts = None
    if args.hostfile:
        hosts = parse_hostfile(args.hostfile)
    elif args.host:
        hosts = parse_host_list(args.host)

    on_failure = "abort"
    if args.enable_recovery:
        on_failure = "restart"
    elif args.ft_continue:
        on_failure = "continue"
    job = Job(args.np, args.command, [tuple(m) for m in args.mca],
              heartbeat_s=args.heartbeat,
              tag_output=not args.no_tag_output,
              hosts=hosts, map_by=args.map_by, rankfile=args.rankfile,
              launch_agent=args.launch_agent,
              on_failure=on_failure,
              max_restarts=args.max_restarts,
              ft_inject=ft_inject)

    def on_signal(signum, frame):
        job._failed.set()
        job.terminate()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    return job.run(timeout_s=args.timeout)


if __name__ == "__main__":
    sys.exit(main())
