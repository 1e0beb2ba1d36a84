"""Seeded chaos scenarios over the simulated fleet.

A scenario is a deterministic script: seed -> staged chaos (cascading
rank deaths, a network partition window, slow-NIC stragglers) -> a
collective episode on the real ``hier_schedules`` code -> the ULFM
recovery shape (authoritative notice push, epoch agreement, the real
``ft_cid`` rebuild derivation, ``clear_revoked``) -> a verified rerun
among the survivors on the rebuilt cid. Because every virtual-time
output of :mod:`.fleet_sim` is a pure function of the seed and the
schedule, one scenario replayed twice produces bit-identical event
logs — chaos as reproducible evidence.

The P=64 smoke configuration stays in tier-1 (seconds); P >= 1024 and
long chaos runs are ``@slow`` test territory.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..coll import hier_schedules as hs
from ..ft import ulfm as _ulfm
from .fleet_sim import FleetSim, log2_rounds


class ChaosResult:
    """Everything a forensics/determinism test needs from one
    scenario run."""

    __slots__ = ("P", "seed", "victims", "straggler", "partition_t1",
                 "survivors", "agreed_epoch", "new_cid", "phase1",
                 "phase2", "event_log_json", "fleet")

    def __init__(self, **kv) -> None:
        for k in self.__slots__:
            setattr(self, k, kv.get(k))


def _fold_sum(parts: List[np.ndarray]) -> np.ndarray:
    acc = parts[0]
    for nxt in parts[1:]:
        acc = acc + nxt
    return acc


def _exact_allreduce(data: Dict[int, np.ndarray], procs: List[int]):
    """fn(x, p): recursive-doubling allreduce (Bruck allgather of the
    per-rank blocks + an index-order local fold) — the exact-order
    schedule, bitwise-reproducible at any P."""
    counts = [int(data[p].size) for p in procs]

    def fn(x, p):
        return _fold_sum(hs.allgather_bruck(x, procs, p, data[p],
                                            counts))

    return fn


def cascading_failure(P: int = 64, *, seed: int = 0,
                      hosts_per: int = 8, deaths: int = 2,
                      partition: bool = True, straggler: bool = True,
                      elems: int = 64,
                      detect_s: float = 2e-3) -> ChaosResult:
    """The multi-failure chaos episode, end to end:

    1. stage ``deaths`` seeded rank deaths mid-schedule, a seeded
       slow-NIC straggler, and (optionally) a healing partition
       between the lower and upper host halves;
    2. run a P-rank allreduce on the real recursive-doubling schedule
       — the deaths cascade through the real FtState machinery into
       typed ``ERR_PROC_FAILED`` / ``ERR_REVOKED`` errors;
    3. recover: push the coordinator's authoritative notice to every
       survivor (epoch agreement), derive the rebuilt cid with the
       real ``ft_cid`` on EVERY survivor's own state (asserting they
       all agree), ``clear_revoked`` the fresh cid;
    4. rerun the allreduce among survivors on the rebuilt cid and
       verify the numeric result against the linear fold.
    """
    rng = np.random.RandomState(seed)
    fleet = FleetSim(P, hosts_per=hosts_per, seed=seed,
                     detect_s=detect_s)
    R = max(1, log2_rounds(P))
    cand = rng.permutation(np.arange(1, P))
    victims = sorted(int(v) for v in cand[:deaths])
    for v in victims:
        fleet.kill(v, at_round=1 + int(rng.randint(0, R)))
    straggler_rank: Optional[int] = None
    if straggler and len(cand) > deaths:
        straggler_rank = int(cand[deaths])
        fleet.fabric.slow_nic(straggler_rank, 4.0)
    partition_t1 = None
    if partition:
        half = P // 2
        partition_t1 = float(rng.uniform(5e-4, 2e-3))
        fleet.fabric.partition(range(half), range(half, P),
                               t0=0.0, t1=partition_t1)

    data = {p: (np.arange(elems, dtype=np.int64) + 1) * (p + 1)
            for p in range(P)}
    cid = 1
    phase1 = fleet.run(
        _exact_allreduce(data, fleet.procs), cid=cid,
        label="allreduce",
        sig=("allreduce", "sum", "int64", elems, -1))

    # -- recovery: agreement + rebuild (the ULFM shrink shape) ------------
    survivors = [p for p in fleet.procs if fleet.ranks[p].alive]
    final = fleet.final_notice()
    for p in survivors:
        r = fleet.ranks[p]
        fleet._apply_notice(r, final, r.now)
    epochs = {int(fleet.ranks[p].ft.epoch) for p in survivors}
    assert len(epochs) == 1, f"agreement failed: {sorted(epochs)}"
    agreed = epochs.pop()
    # every survivor derives the rebuilt cid from ITS OWN agreed
    # epoch through the production derivation — they must all agree
    cids = {_ulfm.ft_cid(int(fleet.ranks[p].ft.epoch), cid)
            for p in survivors}
    assert len(cids) == 1, f"ft_cid disagreement: {sorted(cids)}"
    new_cid = cids.pop()
    for p in survivors:
        fleet.ranks[p].ft.clear_revoked(new_cid)
    t_done = max(fleet.ranks[p].now for p in survivors)
    fleet.record_recovery(survivors[0], new_cid, step=agreed,
                          duration_s=t_done)

    # -- verified rerun among survivors on the rebuilt cid ----------------
    phase2 = fleet.run(
        _exact_allreduce(data, survivors), ranks=survivors,
        cid=new_cid, epoch0=agreed, label="allreduce",
        sig=("allreduce", "sum", "int64", elems, -1))
    want = _fold_sum([data[p] for p in survivors])
    for p in survivors:
        np.testing.assert_array_equal(np.asarray(phase2.value(p)),
                                      want)

    return ChaosResult(P=P, seed=seed, victims=victims,
                       straggler=straggler_rank,
                       partition_t1=partition_t1,
                       survivors=survivors, agreed_epoch=agreed,
                       new_cid=new_cid, phase1=phase1, phase2=phase2,
                       event_log_json=fleet.event_log_json(),
                       fleet=fleet)


class MultiTenantResult:
    """Everything the fairness/isolation tests and the bench
    ``multi_tenant`` suite need from one scenario run."""

    __slots__ = ("P", "seed", "classes", "share_lat", "fifo_share",
                 "lat_ranks", "bulk_ranks", "lat_cid", "bulk_cid",
                 "solo_durations", "qos_durations", "fifo_durations",
                 "bulk_durations", "solo_makespan", "qos_makespan",
                 "fifo_makespan", "killed_rank", "outcomes_lat",
                 "outcomes_bulk", "qos_fleet")

    def __init__(self, **kv) -> None:
        for k in self.__slots__:
            setattr(self, k, kv.get(k))

    @staticmethod
    def p99(durations: Dict[int, float]) -> float:
        return float(np.percentile(
            np.asarray(sorted(durations.values())), 99.0))


def multi_tenant(P: int = 256, *, seed: int = 0, hosts_per: int = 8,
                 classes: str = "latency:8,bulk:2",
                 lat_elems: int = 131072, bulk_elems: int = 131072,
                 kill_bulk: bool = False,
                 detect_s: float = 2e-3) -> MultiTenantResult:
    """N tenants x small fleets over ONE shared fabric — the service
    plane's fairness + FT-isolation scenario.

    Two tenants share every host NIC: the **latency** tenant owns one
    rank per host (P/hosts_per ranks, its own band cid via the real
    :func:`~..ft.ulfm.tenant_cid`), the **bulk** tenant the rest.
    Three deterministic legs on the real ``hier_schedules`` code:

    1. **solo** — the latency tenant's allgather alone on a fresh
       fabric (full wire);
    2. **qos** — both tenants concurrently, each rank's send
       bandwidth scaled to its class's weighted-fair share
       (``service.qos.fair_share`` over the REAL parsed class
       weights — the steady-state guarantee of the WireArbiter,
       modeled deterministically so virtual clocks stay replayable);
    3. **fifo** — the same contention WITHOUT QoS: every sender gets
       1/ranks-per-host of its NIC (the head-of-line share a
       saturating bulk tenant leaves a latency tenant on a fair-less
       wire).

    The fairness claim is two assertions the tests pin: the QoS leg's
    latency makespan stays within ``1/share`` (+margin) of solo, and
    beats the FIFO leg. ``kill_bulk=True`` stages a bulk rank's death
    mid-schedule in the qos leg: the bulk tenant's ranks raise typed
    ``ERR_PROC_FAILED``/``ERR_REVOKED`` on exactly the bulk tenant's
    band cid while every latency rank finishes clean — one tenant's
    failure storm never crosses the band boundary.
    """
    from ..service import qos as _qos

    parsed = _qos.parse_classes(classes)
    share_lat = _qos.fair_share("latency", parsed)
    share_bulk = _qos.fair_share("bulk", parsed)
    fifo_share = 1.0 / hosts_per
    lat_ranks = [p for p in range(P) if p % hosts_per == 0]
    bulk_ranks = [p for p in range(P) if p % hosts_per != 0]
    lat_cid = _ulfm.tenant_cid(0, 0)
    bulk_cid = _ulfm.tenant_cid(1, 0)
    lat_data = {p: np.full(lat_elems, p + 1, np.int64)
                for p in lat_ranks}
    bulk_data = {p: np.arange(bulk_elems, dtype=np.float32)
                 * ((p % 7) + 1) for p in bulk_ranks}
    lat_counts = [lat_elems] * len(lat_ranks)

    def lat_fn(x, p):
        return _fold_sum(hs.allgather_bruck(x, lat_ranks, p,
                                            lat_data[p], lat_counts))

    def bulk_fn(x, p):
        return hs.allreduce_rabenseifner(x, bulk_ranks, p,
                                         bulk_data[p], np.add, 0.0)

    def durations(fleet: FleetSim, ranks) -> Dict[int, float]:
        return {p: fleet.ranks[p].now for p in ranks}

    # -- leg 1: latency tenant solo ---------------------------------------
    solo = FleetSim(P, hosts_per=hosts_per, seed=seed,
                    detect_s=detect_s)
    solo.run(lat_fn, ranks=lat_ranks, cid=lat_cid, label="allgather")
    solo_dur = durations(solo, lat_ranks)

    def contended(shares: Dict[str, float],
                  kill: bool) -> tuple:
        fleet = FleetSim(P, hosts_per=hosts_per, seed=seed,
                         detect_s=detect_s)
        for p in lat_ranks:
            fleet.fabric.bandwidth_share(p, shares["latency"])
        for p in bulk_ranks:
            fleet.fabric.bandwidth_share(p, shares["bulk"])
        if kill:
            fleet.kill(bulk_ranks[1], at_round=2)
        rep = fleet.run(
            lambda x, p: (lat_fn(x, p) if p in lat_data
                          else bulk_fn(x, p)),
            cid=lambda p: lat_cid if p % hosts_per == 0 else bulk_cid,
            label="multi_tenant",
            sig=lambda p: (("allgather", "-", "int64", lat_elems, -1)
                           if p % hosts_per == 0 else
                           ("allreduce", "add", "float32", bulk_elems,
                            -1)))
        return fleet, rep

    # -- leg 2: contended under weighted-fair QoS -------------------------
    qos_fleet, qos_rep = contended(
        {"latency": share_lat, "bulk": share_bulk}, kill_bulk)
    # -- leg 3: contended FIFO (no QoS): per-sender NIC share -------------
    _fifo_fleet, fifo_rep = contended(
        {"latency": fifo_share, "bulk": 1.0 - fifo_share}, False)

    return MultiTenantResult(
        P=P, seed=seed, classes=parsed, share_lat=share_lat,
        fifo_share=fifo_share, lat_ranks=lat_ranks,
        bulk_ranks=bulk_ranks, lat_cid=lat_cid, bulk_cid=bulk_cid,
        solo_durations=solo_dur,
        qos_durations=durations(qos_fleet, lat_ranks),
        fifo_durations=durations(_fifo_fleet, lat_ranks),
        # the bulk tenant's clocks in the SAME contended-QoS leg the
        # lat tenant's qos_durations come from — one leg, both classes
        bulk_durations=durations(qos_fleet, bulk_ranks),
        solo_makespan=max(solo_dur.values()),
        qos_makespan=max(qos_fleet.ranks[p].now for p in lat_ranks),
        fifo_makespan=max(_fifo_fleet.ranks[p].now
                          for p in lat_ranks),
        killed_rank=bulk_ranks[1] if kill_bulk else None,
        outcomes_lat={p: qos_rep.outcomes[p] for p in lat_ranks},
        outcomes_bulk={p: qos_rep.outcomes[p] for p in bulk_ranks},
        qos_fleet=qos_fleet)


def sentinel_desync(P: int = 256, *, divergent_rank: int = 137,
                    divergent_seq: int = 2, seed: int = 0,
                    hosts_per: int = 8) -> FleetSim:
    """A P-rank healthy fleet whose rank ``divergent_rank`` posts a
    mismatched collective signature at posting seq ``divergent_seq``
    while every schedule still completes: the caller-intent desync
    class the contract sentinel exists for. Runs ``divergent_seq + 1``
    bcast rounds on the real binomial schedule, noting signatures
    through the production CallSig chain per rank; returns the fleet
    (callers dump journals and run ``tpu-doctor contracts``)."""
    fleet = FleetSim(P, hosts_per=hosts_per, seed=seed)
    procs = fleet.procs
    val = np.arange(16, dtype=np.int32)
    good = ("allreduce", "sum", "float32", 1024, -1, "trainer.py:203")
    bad = ("bcast", "-", "float32", 1024, 0, "restore.py:88")
    for call in range(divergent_seq + 1):

        def sig(p, _call=call):
            if _call == divergent_seq and p == divergent_rank:
                return bad
            return good

        fleet.run(
            lambda x, p: hs.bcast_binomial(x, procs, p, 0,
                                           val if p == 0 else None),
            cid=1, label="bcast", sig=sig)
    return fleet
