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

Failure policy here is the errmgr default (abort: tear the job down on
the first abnormal exit or heartbeat loss). Not ported yet: restart,
remap, migration and resilient resume (``--enable-recovery``,
``tpu-migrate``), the ULFM degraded world (``--ft-continue``), chaos
injection, and the ``tpu_ps`` responder with its session contact file.
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
                 launch_agent: str = "ssh") -> None:
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
                # the rankfile's named hosts ARE the allocation, so
                # the phantom localhost spec must not survive
                # (parse_rankfile reuses one HostSpec per
                # name, so dedup by id works)
                seen: Dict[int, HostSpec] = {}
                for h in self.rank_hosts:
                    seen.setdefault(id(h), h)
                self.hosts = list(seen.values())
        else:
            self.rank_hosts = map_ranks(self.hosts, num_procs, map_by)
        self.remote = any(not h.is_local for h in self.rank_hosts)
        self.launch_agent = launch_agent
        self.job_state = StateMachine("tpurun-job")
        self.proc_state: Dict[int, int] = {}
        self.hnp: Optional[coord.HnpCoordinator] = None
        self.hnp_host = "127.0.0.1"
        self.procs: Dict[int, subprocess.Popen] = {}
        self._iof_threads: List[threading.Thread] = []
        self._failed = threading.Event()
        self._fin: set = set()
        self._fin_lock = threading.Lock()
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
        self.proc_state[node_id] = ProcState.RUNNING
        for stream, out in ((p.stdout, sys.stdout), (p.stderr, sys.stderr)):
            t = threading.Thread(
                target=self._iof, args=(node_id, stream, out), daemon=True
            )
            t.start()
            self._iof_threads.append(t)

    # -- failure policy (errmgr default_hnp teardown / resilient) ----------
    # -- failure policy (errmgr default_hnp teardown) ----------------------
    def _on_worker_failure(self, node_id: int, state: int) -> None:
        self.proc_state[node_id] = state
        if self._failed.is_set():
            return
        self._failed.set()
        self.job_state.activate(JobState.ABORTED, {"node": node_id,
                                                   "state": int(state)})
        _log.verbose(1, f"worker {node_id} failed "
                        f"({ProcState(state).name}); tearing down")
        self.terminate()

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


    def _reap_segments(self) -> None:
        """Unlink the shm handoff segments the job's local workers
        created and no receiver consumed (a worker that died between a
        peer's handoff and its receive, or an aborted job): every
        segment is named ``ompitpu-<creator pid>-…`` (``btl/components.py``),
        and once the job has ended none of its workers' segments can
        still be in flight — the orte-clean duty, run at every job end."""
        import glob

        for nid, p in self.procs.items():
            if not self.rank_hosts[nid - 1].is_local or p.poll() is None:
                continue
            for path in glob.glob(f"/dev/shm/ompitpu-{p.pid}-*"):
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
            while not self._failed.is_set() and len(self._fin) < self.n:
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
        while (pending or grace) and time.monotonic() < deadline:
            for nid in list(pending):
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
        self.hnp.shutdown()
        for t in self._iof_threads:
            t.join(timeout=2)
        self._reap_segments()

        if self._failed.is_set():
            rc = next((c for c in exit_codes.values() if c), 1)
            return rc
        leftover = next((c for c in exit_codes.values() if c), 0)
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
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="program and arguments to launch")
    args = ap.parse_args(argv)
    if not args.command:
        ap.error("no command given")
    if args.np < 1:
        ap.error("-n must be >= 1")
    if args.hostfile and args.host:
        ap.error("--hostfile and --host are mutually exclusive")
    hosts = None
    if args.hostfile:
        hosts = parse_hostfile(args.hostfile)
    elif args.host:
        hosts = parse_host_list(args.host)

    job = Job(args.np, args.command, [tuple(m) for m in args.mca],
              heartbeat_s=args.heartbeat,
              tag_output=not args.no_tag_output,
              hosts=hosts, map_by=args.map_by, rankfile=args.rankfile,
              launch_agent=args.launch_agent)

    def on_signal(signum, frame):
        job._failed.set()
        job.terminate()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    return job.run(timeout_s=args.timeout)


if __name__ == "__main__":
    sys.exit(main())
