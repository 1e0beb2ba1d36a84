"""Online re-tuning — the sampler's series plane watched for sustained
slow links, answered with a bounded micro-probe and a cvar-applied
rule update.

The fleet metrics plane (:mod:`..obs.sampler`) already produces the
live signal an online re-tuner needs: per-communicator ``coll_bytes``
/ ``coll_seconds`` series points (MB/s once divided) and the skew
pvars. This module closes the loop, gated end to end (``tune_online``
defaults OFF; when off, nothing runs — no hook, no state):

detect
    :class:`OnlineRetuner.observe_points` folds each tick's per-cid
    points into an MB/s sample and keeps a bounded window per comm.
    A sample below ``median(window) / tune_online_slow_factor``
    counts as slow; ``tune_online_sustain`` CONSECUTIVE slow ticks —
    a sustained slow link, not one hiccup — trigger a re-tune
    (cooldown-limited, so a flapping link cannot probe-storm).

probe
    A BOUNDED micro-probe re-measures the schedule menu: the pluggable
    ``probe(cid)`` callable returns replacement rule text (or None to
    decline). :func:`fleet_probe` is the built-in model-based probe —
    one run per candidate algorithm of the real schedule code over a
    :class:`~..testing.fleet_sim.Fabric` mirror of the observed
    topology (straggler included), deterministic and device-free.

apply
    The winning rules register into the tuning database
    (:mod:`.db` — a NEW version, the measured trail survives) and the
    selection lands via a CVAR WRITE (``coll_tuned_dynamic_rules_
    filename`` -> the new entry). That write bumps the MCA registry's
    write generation, which is exactly the frozen plans' contract: every
    frozen ``SchedulePlan`` re-plans at its NEXT fire, never
    mid-schedule — an online re-tune can never corrupt a round in
    flight.

Arming rides ``Runtime.init`` next to the sampler: when
``tune_online`` is set (and obs + the sampler are live), the retuner
registers a post-tick hook on :data:`..obs.sampler.TICK_HOOKS` and
drains new series points each tick.
"""

from __future__ import annotations

import statistics
import time as _time
from collections import deque
from typing import Callable, Dict, List, Optional

from .. import obs as _obs
from ..mca import pvar
from ..mca import var as mca_var
from ..utils import output

_log = output.stream("tuning")

_slow_flags = pvar.counter(
    "tune_slow_link_flags",
    "sampler ticks whose per-comm MB/s fell below the sustained-slow "
    "threshold (baseline / tune_online_slow_factor)",
)
_probe_timer = pvar.timer(
    "tune_probe_seconds",
    "accumulated seconds spent in online re-tune micro-probes "
    "(bounded: one run per candidate algorithm)",
)
_retunes = pvar.counter(
    "tune_retunes_applied",
    "online re-tunes applied (rule registered into the tuning db and "
    "selected via the generation-bumping cvar write)",
)


def register_vars() -> None:
    mca_var.register(
        "tune_online", "bool", False,
        "Arm the online re-tuner on the continuous sampler's tick "
        "hook: sustained per-comm MB/s degradation triggers a bounded "
        "micro-probe and a cvar-applied rule update (requires obs + "
        "obs_sample_interval > 0; plans re-freeze at the next fire)",
    )
    mca_var.register(
        "tune_online_window", "int", 8,
        "Rolling window (sampler ticks) of per-comm MB/s samples the "
        "slow-link baseline is the median of",
    )
    mca_var.register(
        "tune_online_sustain", "int", 3,
        "Consecutive below-threshold ticks before a re-tune triggers "
        "(one hiccup is not a slow link)",
    )
    mca_var.register(
        "tune_online_slow_factor", "float", 2.0,
        "A tick is 'slow' when its MB/s < window median / this factor",
    )
    mca_var.register(
        "tune_online_cooldown_s", "float", 120.0,
        "Minimum seconds between applied re-tunes per communicator "
        "(a flapping link must not probe-storm)",
    )


register_vars()  # idempotent; cvars must exist before any arm


class OnlineRetuner:
    """Sustained-slow-link detector + probe/apply driver. ``probe`` is
    ``probe(cid) -> Optional[str]`` returning replacement rule text;
    ``db_dir`` defaults to the ``coll_tuning_db_dir`` cvar at apply
    time. ``clock`` is injectable for deterministic tests."""

    def __init__(self, probe: Optional[Callable[[int], Optional[str]]]
                 = None, db_dir: Optional[str] = None,
                 clock: Callable[[], float] = _time.monotonic) -> None:
        self.probe = probe
        self.db_dir = db_dir
        self.clock = clock
        self._rates: Dict[int, deque] = {}
        self._slow: Dict[int, int] = {}
        self._last_apply: Dict[int, float] = {}
        self._cursor = 0
        #: applied re-tunes, newest last: {"cid", "path", "t"} — the
        #: forensic trail tests and tpu-doctor read
        self.applied: List[Dict] = []

    # -- detection ---------------------------------------------------------
    def observe_rate(self, cid: int, mb_s: float) -> bool:
        """Fold one per-comm MB/s sample; True when this sample
        completes a sustained-slow streak (trigger)."""
        window = max(2, int(mca_var.get("tune_online_window", 8)))
        factor = float(mca_var.get("tune_online_slow_factor", 2.0))
        sustain = max(1, int(mca_var.get("tune_online_sustain", 3)))
        dq = self._rates.setdefault(cid, deque(maxlen=window))
        trigger = False
        if len(dq) >= max(2, window // 2):
            base = statistics.median(dq)
            if base > 0 and mb_s < base / max(1.0, factor):
                _slow_flags.add()
                self._slow[cid] = self._slow.get(cid, 0) + 1
                if self._slow[cid] >= sustain:
                    cooldown = float(
                        mca_var.get("tune_online_cooldown_s", 120.0))
                    last = self._last_apply.get(cid)
                    if last is None or \
                            self.clock() - last >= cooldown:
                        trigger = True
                        self._slow[cid] = 0
            else:
                self._slow[cid] = 0
        dq.append(float(mb_s))
        return trigger

    def observe_points(self, points: List[Dict]) -> List[int]:
        """Fold a batch of sampler series points (the ring's dict
        shape); returns the cids whose streak completed. One (tick,
        cid) pair folds to one MB/s sample — coll_bytes over
        coll_seconds, the sampler's per-comm rate series."""
        acc: Dict[tuple, Dict[str, float]] = {}
        order: List[tuple] = []
        for pt in points:
            name = pt.get("name")
            if name not in ("coll_bytes", "coll_seconds"):
                continue
            key = (pt.get("t"), pt.get("cid"))
            if key not in acc:
                acc[key] = {}
                order.append(key)
            acc[key][name] = float(pt.get("v") or 0.0)
        triggered: List[int] = []
        for key in order:
            secs = acc[key].get("coll_seconds", 0.0)
            if secs <= 0:
                continue
            mb_s = acc[key].get("coll_bytes", 0.0) / secs / 1e6
            cid = int(key[1])
            if self.observe_rate(cid, mb_s) and cid not in triggered:
                triggered.append(cid)
        return triggered

    # -- probe + apply -----------------------------------------------------
    def retune(self, cid: int) -> Optional[str]:
        """Run the bounded micro-probe for one flagged comm and apply
        its verdict; returns the registered rules path (None when no
        probe is configured or it declined)."""
        if self.probe is None:
            _log.verbose(1, f"online retune: cid {cid} flagged "
                            "sustained-slow; no probe configured")
            return None
        rec = _obs.enabled
        t0 = _time.perf_counter() if rec else 0.0
        with _probe_timer.timing():
            text = self.probe(cid)
        if rec and _obs.enabled:
            _obs.record("retune_probe", "tune", t0,
                        _time.perf_counter() - t0, comm_id=cid)
        if not text:
            return None
        return self.apply(text, cid=cid)

    def apply(self, rule_text: str, cid: int = -1) -> str:
        """Register the re-measured rules as a NEW tuning-db version
        and select them via the cvar write that bumps the MCA write
        generation — frozen plans re-freeze at the next fire."""
        from . import db as _db

        root = self.db_dir or \
            str(mca_var.get("coll_tuning_db_dir", "") or "")
        if not root:
            raise ValueError(
                "online retune needs a tuning database: set "
                "coll_tuning_db_dir (or pass db_dir)")
        rec = _obs.enabled
        t0 = _time.perf_counter() if rec else 0.0
        path = _db.TuningDb(root).register(
            rule_text, _db.active(), source="online-retune")
        # THE generation-bumping write: selection moves to the new
        # entry AND every frozen SchedulePlan re-plans at its next
        # fire (coll/plan stamps plans with VARS.generation)
        mca_var.set_value("coll_tuned_use_dynamic_rules", True)
        mca_var.set_value("coll_tuned_dynamic_rules_filename", path)
        self._last_apply[cid] = self.clock()
        self.applied.append({"cid": cid, "path": path,
                             "t": self.clock()})
        _retunes.add()
        if rec and _obs.enabled:
            _obs.record("retune_apply", "tune", t0,
                        _time.perf_counter() - t0, comm_id=cid)
        _log.warn(f"online retune applied for comm {cid}: {path}")
        return path

    # -- sampler hook ------------------------------------------------------
    def tick(self) -> None:
        """Post-tick hook: drain the series ring incrementally and
        act on completed streaks. Never raises (the sampler's plane
        must survive a broken consumer — it also guards, belt and
        braces)."""
        try:
            from ..obs import sampler as _sampler

            pts, self._cursor = _sampler.RING.drain_since(self._cursor)
            for cid in self.observe_points(pts):
                self.retune(cid)
        except Exception as e:  # pragma: no cover - defensive
            _log.verbose(1, f"online retune tick failed: {e}")


# ---------------------------------------------------------------------------
# the built-in model-based micro-probe
# ---------------------------------------------------------------------------

def fleet_probe(P: int, hosts_per: int, n_elems: int = 4096,
                algs=("ring", "multiring", "torus2d"), seed: int = 0,
                fabric_factory: Optional[Callable] = None,
                min_comm_size: int = 0, min_bytes: int = 0) -> str:
    """Bounded, deterministic micro-probe: ONE run per candidate
    allreduce schedule of the real round code over a virtual-fabric
    mirror of the observed topology (``fabric_factory`` injects the
    straggler picture; default = a clean ``hosts_per`` fabric).
    Returns a ``hier_allreduce`` rule line naming the winner by
    virtual makespan. Device-free — runnable from a live job without
    touching the wire."""
    import numpy as np

    from ..coll import hier_schedules as _hs
    from ..coll import topo_schedules as _topo
    from ..testing import fleet_sim as _fs

    def default_factory():
        return _fs.Fabric(P, hosts_per=hosts_per, seed=seed)

    factory = fabric_factory or default_factory
    procs = list(range(P))
    data = {p: np.arange(int(n_elems), dtype=np.float32) * (p % 3 + 1)
            for p in procs}
    makespans: Dict[str, float] = {}
    for alg in algs:
        fleet = _fs.FleetSim(P, fabric=factory(), seed=seed)
        host_of = fleet.fabric.host_of

        def fn(x, p, alg=alg, host_of=host_of):
            if alg == "multiring":
                return _topo.allreduce_multiring(
                    x, procs, p, data[p], np.add, 0.0,
                    int(mca_var.get("hier_multiring_k", 4)))
            if alg == "torus2d":
                return _topo.allreduce_torus2d(
                    x, procs, p, data[p], np.add, 0.0, host_of)
            return _hs.allreduce_ring(x, procs, p, data[p], np.add,
                                      0.0)

        rep = fleet.run(fn, label=f"probe_{alg}")
        if len(rep.ok()) == P:
            makespans[alg] = rep.makespan
    if not makespans:
        raise RuntimeError("fleet probe: every candidate failed")
    winner = min(sorted(makespans), key=makespans.get)
    just = ", ".join(f"{a}={makespans[a] * 1e3:.3f}ms"
                     for a in sorted(makespans, key=makespans.get))
    return (f"# online re-tune micro-probe (P={P}, hosts_per="
            f"{hosts_per}, {int(n_elems)} f32): {just}\n"
            f"hier_allreduce  {int(min_comm_size)}  {int(min_bytes)}"
            f"  {winner}\n")


# ---------------------------------------------------------------------------
# lifecycle (Runtime.init / finalize, next to the sampler)
# ---------------------------------------------------------------------------

RETUNER: Optional[OnlineRetuner] = None


def default_probe(cid: int) -> Optional[str]:
    """The probe a production arm gets when none is injected: a
    :func:`fleet_probe` over a virtual mirror of the job's ACTIVE
    topology fingerprint (:func:`..tuning.db.active` — published at
    comm construction). Declines (None) for single-process or ragged
    layouts the fleet model cannot mirror, so a trigger there is a
    logged no-op rather than a bogus rule."""
    from . import db as _db

    fp = _db.active()
    if fp.P < 2:
        return None
    hosts_per = fp.procs_per_host
    if hosts_per <= 0:  # ragged layout: no uniform mirror to probe
        return None
    return fleet_probe(fp.P, hosts_per)


def maybe_start(runtime=None,
                probe: Optional[Callable] = None) -> bool:
    """Arm the retuner iff ``tune_online`` is set and obs is enabled
    (the sampler's tick hook is the drive shaft — without
    ``obs_sample_interval`` > 0 nothing ever ticks). Zero cost when
    off: no object, no hook. Without an injected ``probe`` the
    built-in :func:`default_probe` runs, so the detect->probe->apply
    loop is live in production, not just in tests."""
    global RETUNER
    if not _obs.enabled or not bool(mca_var.get("tune_online", False)):
        return False
    from ..obs import sampler as _sampler

    if RETUNER is None:
        RETUNER = OnlineRetuner(probe=probe or default_probe)
    if RETUNER.tick not in _sampler.TICK_HOOKS:
        _sampler.TICK_HOOKS.append(RETUNER.tick)
    return True


def stop() -> None:
    global RETUNER
    if RETUNER is not None:
        from ..obs import sampler as _sampler

        try:
            _sampler.TICK_HOOKS.remove(RETUNER.tick)
        except ValueError:
            pass
    RETUNER = None


def _reset_for_tests() -> None:
    stop()
