"""Failure detection + fault injection — the ``orte/mca/sensor``
analogue (counterpart of ``ompi_release_tpu/ft/sensor.py``).

- Heartbeat: periodic beats with a miss limit; missing beats fires the
  failure callback (``sensor_heartbeat.c:61,78`` check_heartbeat).
- FtTester: probabilistic fault injection for exercising errmgr paths
  (``sensor_ft_tester.c:67-106`` random kills, here raised as
  InjectedFault so tests/restart loops can exercise recovery).
- resource_usage: /proc vmsize/rss sampling (``pstat_linux_module``).
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Callable, Dict, Optional

from ..mca import var as mca_var
from ..utils import output

_log = output.stream("sensor")


class InjectedFault(RuntimeError):
    """Raised by FtTester to simulate a process failure."""


class Heartbeat:
    """Monitor thread: the watched party calls beat(); if more than
    ``miss_limit`` intervals pass without one, ``on_failure`` fires."""

    def __init__(self, interval_s: float = 1.0, miss_limit: int = 3,
                 on_failure: Optional[Callable[[], None]] = None) -> None:
        self.interval_s = interval_s
        self.miss_limit = miss_limit
        self.on_failure = on_failure
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._failed = False
        self._thread: Optional[threading.Thread] = None

    def beat(self) -> None:
        self._last = time.monotonic()

    @property
    def failed(self) -> bool:
        return self._failed

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s / 2):
            silent = time.monotonic() - self._last
            if silent > self.interval_s * self.miss_limit:
                self._failed = True
                _log.verbose(
                    1, f"heartbeat missed for {silent:.2f}s -> failure"
                )
                if self.on_failure is not None:
                    self.on_failure()
                return

    def start(self) -> "Heartbeat":
        # the clock starts when monitoring starts — construction-to-
        # start delay must not count as missed beats
        self._last = time.monotonic()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)


class FtTester:
    """Fault injector (``sensor/ft_tester``), three modes composable
    per step/call:

    - probabilistic: ``maybe_fail()`` raises :class:`InjectedFault`
      with probability ``fail_prob``. Seeded via ``ft_seed``
      (``sensor_ft_seed`` cvar) so chaos runs REPLAY: the same seed
      injects at the same call sequence — a flake found in CI can be
      reproduced exactly.
    - every-N deterministic: ``step()`` raises at every ``every_n``-th
      step (``sensor_ft_every_n`` cvar) — the job tests' scheduled
      soft fault.
    - hard kill: ``step()`` SIGKILLs the process at ``kill_step``
      (``sensor_ft_kill_step`` / ``sensor_ft_kill_rank`` cvars; the
      ``tpurun --ft-inject rank:step`` chaos flag arms exactly this in
      the chosen child) — the real rank-death the ULFM recovery plane
      exists for. SIGKILL, deliberately: no atexit, no FIN, no flushed
      heartbeat — the corpse the detectors must find.
    """

    def __init__(self, fail_prob: Optional[float] = None,
                 seed: Optional[int] = None,
                 every_n: int = 0,
                 kill_step: int = -1) -> None:
        if fail_prob is None:
            fail_prob = float(mca_var.get("sensor_ft_tester_prob", 0.0))
        if seed is None:
            cvar_seed = int(mca_var.get("sensor_ft_seed", 0) or 0)
            seed = cvar_seed if cvar_seed else None
        self.fail_prob = fail_prob
        self.every_n = int(every_n)
        self.kill_step = int(kill_step)
        self.seed = seed  # retained: replayability is inspectable
        self._rng = random.Random(seed)
        self.injected = 0
        self.steps = 0

    @classmethod
    def from_cvars(cls, process_index: int = 0) -> "FtTester":
        """A tester armed purely from the ``sensor_ft_*`` cvars, with
        the kill scoped to ``sensor_ft_kill_rank`` (-1 = any process
        that has ``sensor_ft_kill_step`` set — tpurun's --ft-inject
        exports the step cvar only into the chosen child)."""
        kill_step = int(mca_var.get("sensor_ft_kill_step", -1))
        kill_rank = int(mca_var.get("sensor_ft_kill_rank", -1))
        if kill_rank >= 0 and kill_rank != int(process_index):
            kill_step = -1
        return cls(every_n=int(mca_var.get("sensor_ft_every_n", 0) or 0),
                   kill_step=kill_step)

    def maybe_fail(self, where: str = "") -> None:
        if self._rng.random() < self.fail_prob:
            self.injected += 1
            _log.verbose(1, f"ft_tester: injecting fault at {where}")
            raise InjectedFault(f"injected fault at {where or 'unknown'}")

    def kill_now(self, why: str = "") -> None:
        """The sensor's hard kill: SIGKILL self (no teardown runs)."""
        import signal
        import sys

        _log.verbose(0, f"ft_tester: SIGKILL self "
                        f"({why or 'armed kill'})")
        sys.stdout.flush()
        sys.stderr.flush()
        os.kill(os.getpid(), signal.SIGKILL)

    def step(self) -> int:
        """Advance the per-step injection clock: fires the armed hard
        kill at ``kill_step``, raises the deterministic every-N fault,
        then runs the probabilistic check. Returns the step index
        just accounted."""
        s = self.steps
        self.steps += 1
        if self.kill_step >= 0 and s == self.kill_step:
            self.kill_now(f"--ft-inject at step {s}")
        if self.every_n > 0 and s > 0 and s % self.every_n == 0:
            self.injected += 1
            raise InjectedFault(
                f"deterministic every-{self.every_n} fault at step {s}")
        self.maybe_fail(f"step {s}")
        return s


def register_vars() -> None:
    mca_var.register(
        "sensor_ft_tester_prob", "float", 0.0,
        "Probability of injected failure per maybe_fail() call "
        "(sensor_ft_tester.c analogue)",
    )
    mca_var.register(
        "sensor_ft_seed", "int", 0,
        "Seed for the probabilistic fault injector (0 = unseeded); a "
        "seeded chaos run injects at a reproducible call sequence",
    )
    mca_var.register(
        "sensor_ft_every_n", "int", 0,
        "Deterministic injection: FtTester.step() raises at every "
        "N-th step (0 = off) — the job tests' scheduled soft fault",
    )
    mca_var.register(
        "sensor_ft_kill_step", "int", -1,
        "Hard chaos: FtTester.step() SIGKILLs this process at the "
        "given step (-1 = off); armed per child by "
        "tpurun --ft-inject rank:step",
    )
    mca_var.register(
        "sensor_ft_kill_rank", "int", -1,
        "Scope sensor_ft_kill_step to one process index when the cvar "
        "reaches every worker (-1 = any process with the step set)",
    )
    mca_var.register(
        "sensor_heartbeat_interval", "float", 1.0,
        "Heartbeat period in seconds",
    )


register_vars()  # idempotent; the ft cvars must resolve their
#                  OMPITPU_MCA_* env overrides before the first tester


def resource_usage() -> Dict[str, int]:
    """vmsize/rss in bytes from /proc/self/status (pstat/linux); zeros
    where it is missing — the sample every heartbeat carries."""
    out = {"vmsize": 0, "rss": 0}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmSize:"):
                    out["vmsize"] = int(line.split()[1]) * 1024
                elif line.startswith("VmRSS:"):
                    out["rss"] = int(line.split()[1]) * 1024
    except OSError:
        pass
    return out
