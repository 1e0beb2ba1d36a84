"""tpu-tune — measure collective algorithms and emit a dynamic rule
file.

The reference ships tuned's decision constants baked in and leaves the
operator to hand-write a dynamic rules file
(``ompi/mca/coll/tuned/coll_tuned_dynamic_file.c`` reads it; nothing
generates it). This tool closes that loop: it times EVERY legal
algorithm of each tunable collective at each sweep size on the actual
device mesh, picks the winner, and writes a
``coll/dynamic_rules.py``-format file whose comments carry the
measurements that justify each rule — load it with::

    --mca coll_tuned_use_dynamic_rules 1 \\
    --mca coll_tuned_dynamic_rules_filename FILE

Sizes in the emitted rules are each collective's own decision unit
(per-rank bytes, total bytes for allgather, per-destination block for
alltoall/scatter — the same units ``dynamic_rules.lookup`` is queried
with; see that module's table).

Timing protocol: the first call of every (algorithm, size) records
its plan (on the card the second captures the plan's CUDA graph); a
row's time is the best of the repeats that follow, so neither is
timed. The first call's extra cost is still reported — as a separate
``compile:`` field in the emitted rule-file comments, the reference's
name — because an operator choosing between algorithms with similar
steady-state times may care which one stalls the first iteration
longer.

``--segsizes`` additionally sweeps the pipeline segment size
(``coll/pipeline.py``) for rows whose winner is pipeline-capable (ring
allreduce, binomial bcast/reduce) and emits the winning value as the
rule file's fifth ``segsize`` column (0 pins pipelining off when
monolithic won), with the per-segsize measurements in a comment.

Every timed call is closed by a synchronisation of the card
(``torch.cuda.synchronize``), so a time is the collective's, not its
launch's. The sweeps run on ``cuda:0`` unless ``--device cpu``; the
hier and tree sweeps' workers share that device.

Usage::

    python -m ompi_release_tpu_torch.tools.tpu_tune -o rules.conf \\
        [--sizes 1024,65536,1048576] [--repeats 5] [--ops allreduce,...] \\
        [--segsizes 65536,262144,1048576] [--ranks 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..mca import var as mca_var
from ..tuning import db as tuning_db
from ..utils import output

_log = output.stream("tune")


def measured_fingerprint(hier_procs: int = 0,
                         hosts_per: int = 0) -> tuning_db.Fingerprint:
    """The topology fingerprint a tpu-tune run actually measured: the
    hier sweep's process/host layout when one ran (that is what the
    hier_* rules are valid for), else the single-process in-process
    mesh (:data:`..tuning.db.LOCAL`)."""
    if hier_procs >= 2:
        hp = int(hosts_per) if hosts_per and hosts_per > 0 \
            else int(hier_procs)
        hosts = -(-int(hier_procs) // hp)
        return tuning_db.Fingerprint(
            hosts=hosts, procs_per_host=hp if hier_procs % hp == 0
            else 0,
            link_classes=("shm", "dcn") if hosts > 1 else ("shm",),
            P=int(hier_procs))
    return tuning_db.LOCAL

#: op -> (runner(comm, x), decision-unit bytes for per-rank bytes b
#: and comm size n)
_OPS: Dict[str, Tuple] = {
    "allreduce": (lambda c, x: c.allreduce(x), lambda b, n: b),
    "bcast": (lambda c, x: c.bcast(x, root=0), lambda b, n: b),
    "reduce": (lambda c, x: c.reduce(x, root=0), lambda b, n: b),
    "allgather": (lambda c, x: c.allgather(x), lambda b, n: b * n),
    "alltoall": (lambda c, x: c.alltoall(x), lambda b, n: b // n),
    "gather": (lambda c, x: c.gather(x, root=0), lambda b, n: b),
    "scatter": (lambda c, x: c.scatter(x, root=0), lambda b, n: b // n),
}


def unit_bytes(op: str, nbytes: int, n: int) -> int:
    """The decision unit of ``op``'s rules for ``nbytes`` per rank on
    a comm of size ``n`` (the unit ``dynamic_rules.lookup`` is queried
    with)."""
    return _OPS[op][1](nbytes, n)


def _algorithms(op: str) -> List[str]:
    from ..coll import dynamic_rules

    return [a for a in dynamic_rules.RULE_COLLECTIVES[op]
            if a != "auto"]


def _sync(device) -> None:
    """Wait for the card's queued work (a no-op on the host)."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_once(fn, comm, x) -> float:
    _sync(x.device)  # start from an idle card
    t0 = time.perf_counter()
    fn(comm, x)
    _sync(x.device)
    return time.perf_counter() - t0


def _tuned_dup(comm):
    """A dup whose c_coll table is served by the tuned component:
    ``coll_tuned_<op>_algorithm`` forcing and rule files only act
    through the tuned pickers, while a default comm's chain is led by
    xla (priority 100) — measuring there would time xla's one program
    under every forced name and crown a noise winner."""
    mca_var.set_value("coll", "tuned")
    try:
        return comm.dup(name="tune_tuned")
    finally:
        mca_var.VARS.unset("coll")


def sweep_segsizes(comm, op: str, alg: str, x,
                   segsizes: Sequence[int], repeats: int = 5
                   ) -> Dict[int, float]:
    """Time ``alg`` under each pipeline segment size (plus 0 = the
    monolithic baseline); returns {segsize: best_seconds}. The cvar
    under sweep is ``coll_pipeline_segsize`` — exactly what the
    emitted rule's ``segsize`` column will set per matching call.

    Dynamic rules are pinned OFF for the sweep: a live rules file's
    segsize column outranks the swept cvar (pick_segsize: rules >
    cvar), which would make every sweep point measure the same
    configuration when re-tuning an already-tuned deployment.
    Segment sizes >= the per-rank message are skipped — they compile
    the identical monolithic program as 0 and would only let timer
    noise crown a never-exercised value."""
    runner, _ = _OPS[op]
    var = f"coll_tuned_{op}_algorithm"
    msg_bytes = int(x[0].numel()) * int(x.element_size())
    out: Dict[int, float] = {}
    prev_rules = mca_var.get("coll_tuned_use_dynamic_rules", False)
    prev_seg = mca_var.get("coll_pipeline_segsize", 1 << 20)
    prev_alg = mca_var.get(var, "auto")
    mca_var.set_value("coll_tuned_use_dynamic_rules", False)
    mca_var.set_value(var, alg)
    try:
        for seg in [0] + [s for s in segsizes if 0 < s < msg_bytes]:
            mca_var.set_value("coll_pipeline_segsize", seg)
            try:
                _time_once(runner, comm, x)  # compile + prime plan cache
                out[seg] = min(
                    _time_once(runner, comm, x) for _ in range(repeats)
                )
            except Exception as e:
                _log.verbose(2, f"{op}/{alg} segsize {seg}: {e}")
    finally:
        # restore (not clobber): the operator may have forced their
        # own algorithm/segsize before running tpu-tune
        mca_var.set_value("coll_pipeline_segsize", prev_seg)
        mca_var.set_value(var, prev_alg)
        mca_var.set_value("coll_tuned_use_dynamic_rules", prev_rules)
    return out


def sweep_wire_segsizes(segsizes: Sequence[int],
                        size_bytes: int = 16 << 20,
                        repeats: int = 3) -> Dict[int, float]:
    """Time ONE cross-process-shaped staged transfer through a real
    loopback OOB endpoint pair at each ``wire_pipeline_segsize`` (0 =
    the legacy monolithic ``tobytes()`` framing); returns
    {segsize: best_seconds}. This sweeps the cvar the wire router's
    DCN staging path reads (``DcnBtl.pipeline_segsize``), so the
    emitted recommendation measures the exact send+reassemble code a
    ``tpurun`` job will run — sockets, framing, CRC and all."""
    from ..btl.components import DcnBtl
    from ..native import OobEndpoint

    a, b = OobEndpoint(0), OobEndpoint(1)
    out: Dict[int, float] = {}
    prev = mca_var.get("wire_pipeline_segsize", 1 << 20)
    try:
        b.connect(0, "127.0.0.1", a.port)
        m = DcnBtl()
        x = np.ones(max(1, size_bytes // 4), np.float32)
        for seg in [0] + sorted({int(s) for s in segsizes if s > 0}):
            mca_var.set_value("wire_pipeline_segsize", seg)
            try:
                best = None
                for _ in range(repeats):
                    t0 = time.perf_counter()
                    m.send_staged(b, 0, 151, x)
                    got = np.asarray(m.recv_staged(a, 151))
                    dt = time.perf_counter() - t0
                    best = dt if best is None else min(best, dt)
                if got.shape != x.shape or got[0] != x[0]:
                    continue  # never crown a corrupting config
                out[seg] = best
            except Exception as e:
                _log.verbose(2, f"wire segsize {seg}: {e}")
    finally:
        mca_var.set_value("wire_pipeline_segsize", prev)
        a.close()
        b.close()
    return out


def emit_wire_rules(seg_times: Dict[int, float],
                    size_bytes: int = 16 << 20) -> str:
    """Rule-comment block for the wire sweep (the same measured-
    justification treatment as the coll segsize column): every point's
    time, plus the winning ``--mca wire_pipeline_segsize`` the operator
    should launch with. Wire cvars are job-wide, not per-collective, so
    this block is advisory comments rather than rule lines — the
    loader ignores it."""
    if not seg_times:
        return ""
    pts = ", ".join(
        f"{('off' if k == 0 else k)}={v * 1e3:.1f}ms"
        for k, v in sorted(seg_times.items(), key=lambda kv: kv[1]))
    best = min(seg_times, key=seg_times.get)
    lines = [
        "",
        f"# wire pipeline sweep ({size_bytes >> 20} MiB staged "
        f"loopback): {pts}",
        f"# recommended: --mca wire_pipeline_segsize {best}"
        + ("  (legacy monolithic framing won)" if best == 0 else ""),
    ]
    return "\n".join(lines)


#: worker app for the hier sweep: a REAL loopback tpurun job (one
#: device per process, so comm size == process count) that times every
#: legal INTER schedule of each spanning collective under the
#: ``hier_inter_algorithm`` forcing cvar. Process 0 writes the rows to
#: OMPITPU_HIER_TUNE_OUT.
_HIER_TUNE_APP = r'''
import json, os, sys, time
sys.path.insert(0, %(repo)r)
# --hier-hosts-per: group processes into fake hosts of that size so
# the sweep times the topology-aware schedules (multiring/torus2d)
# over a real shm/DCN split instead of one flat host. NODE_ID is
# 1-BASED (tpurun): subtract 1 or the groups come out ragged and
# torus_grid() would silently degrade every torus leg to the flat
# ring while the sweep labels the timings torus2d.
_hp = int(os.environ.get("OMPITPU_HIER_TUNE_HOSTS_PER", "0"))
if _hp > 0:
    os.environ["OMPITPU_HOST_ID"] = (
        "tunehost-%%d"
        %% ((int(os.environ["OMPITPU_NODE_ID"]) - 1) // _hp))
import numpy as np
import torch
import ompi_release_tpu_torch as mpi
from ompi_release_tpu_torch.coll import hier_schedules
from ompi_release_tpu_torch.mca import var as mca_var
from ompi_release_tpu_torch.runtime.runtime import Runtime

OPS = json.loads(os.environ["OMPITPU_HIER_TUNE_OPS"])
SIZES = json.loads(os.environ["OMPITPU_HIER_TUNE_SIZES"])
REPEATS = int(os.environ.get("OMPITPU_HIER_TUNE_REPEATS", "3"))
dev = torch.device(os.environ["OMPITPU_TUNE_DEVICE"])
world = mpi.init(cli_args=["--mca", "runtime_virtual_ranks", "1"],
                 device=dev)

def sync():
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
rt = Runtime.current()
me = rt.bootstrap["process_index"]
n = world.size

def runner(op, x):
    if op == "allreduce":
        return world.allreduce(x)
    if op == "bcast":
        return world.bcast(x, root=0)
    if op == "reduce":
        return world.reduce(x, root=0)
    if op == "allgather":
        return world.allgather(x)
    if op == "alltoall":
        return world.alltoall(x)
    if op == "gather":
        return world.gather(x, root=0)
    if op == "scatter":
        return world.scatter(x, root=0)
    raise ValueError(op)

def unit_bytes(op, elems):
    # the hier decision units pick() documents
    if op == "allgather":
        return elems * 4 * n
    if op == "alltoall":
        return (elems // n) * 4
    if op == "scatter":
        return 0  # size-blind decision (root-only buffer)
    return elems * 4

results = {}
for op in OPS:
    rows = []
    for size in SIZES:
        elems = max(n, size // 4)
        elems = -(-elems // n) * n
        x = torch.ones((1, elems), dtype=torch.float32, device=dev)
        times = {}
        for alg in hier_schedules.ALGORITHMS[op]:
            if alg == "auto":
                continue
            mca_var.set_value("hier_inter_algorithm", alg)
            try:
                world.barrier()
                runner(op, x)  # warm the shadow-comm programs
                best = None
                for _ in range(REPEATS):
                    world.barrier()
                    sync()
                    t0 = time.perf_counter()
                    runner(op, x)
                    sync()
                    dt = time.perf_counter() - t0
                    best = dt if best is None else min(best, dt)
                times[alg] = best
            except Exception as e:
                if me == 0:
                    print("hier-tune skip %%s/%%s@%%d: %%s"
                          %% (op, alg, size, e), file=sys.stderr)
            finally:
                mca_var.VARS.unset("hier_inter_algorithm")
        if times:
            rows.append({"size": size,
                         "unit_bytes": unit_bytes(op, elems),
                         "times": times,
                         "winner": min(times, key=times.get)})
    results[op] = rows
world.barrier()
if me == 0:
    # witness that the topo family actually ran (a ragged fake-host
    # grouping would silently degrade torus2d to the flat ring and
    # this would read 0 — the hosts-per sweep test pins it > 0)
    from ompi_release_tpu_torch.mca import pvar as _pvar
    _tr = _pvar.PVARS.lookup("hier_topo_schedule_runs")
    with open(os.environ["OMPITPU_LOOPBACK_OUT"], "w") as f:
        json.dump({"nprocs": n, "results": results,
                   "topo_runs": float(_tr.read()) if _tr else 0.0}, f)
mpi.finalize()
'''


#: worker app for the tree-bucket sweep: a REAL loopback tpurun job
#: driving parallel/tree.TreeSync whole-tree allreduce passes over a
#: trainer-shaped mixed-size gradient tree at each candidate bucket
#: capacity (0 = the per-leaf path). Process 0 writes the rows to
#: OMPITPU_LOOPBACK_OUT.
_TREE_TUNE_APP = r'''
import json, os, sys, time
sys.path.insert(0, %(repo)r)
# distinct shm identity per worker: the pass rides the DCN staged
# path, so the sweep times real wire traffic, not a memcpy
os.environ["OMPITPU_HOST_ID"] = (
    "treetune-" + os.environ["OMPITPU_NODE_ID"])
import numpy as np
import torch
import ompi_release_tpu_torch as mpi
from ompi_release_tpu_torch.parallel import tree as tree_mod
from ompi_release_tpu_torch.runtime.runtime import Runtime

BUCKETS = json.loads(os.environ["OMPITPU_TREE_TUNE_BUCKETS"])
REPEATS = int(os.environ.get("OMPITPU_TREE_TUNE_REPEATS", "3"))
dev = torch.device(os.environ["OMPITPU_TUNE_DEVICE"])
world = mpi.init(cli_args=["--mca", "runtime_virtual_ranks", "1"],
                 device=dev)
rt = Runtime.current()
me = rt.bootstrap["process_index"]
ln = len(world.local_comm_ranks)

# a trainer-shaped tree: many small leaves (biases/norms), a medium
# band (projections), a couple of large ones (embeddings)
rng = np.random.RandomState(7)
grads = {}
for k in range(16):
    grads["small%%02d" %% k] = rng.randn(ln, 1024).astype(np.float32)
for k in range(6):
    grads["mid%%d" %% k] = rng.randn(ln, 16384).astype(np.float32)
for k in range(2):
    grads["big%%d" %% k] = rng.randn(ln, 131072).astype(np.float32)
metas = [(g.shape, g.dtype) for g in
         (grads[k] for k in sorted(grads))]
total = sum(g.nbytes for g in grads.values())
grads = {k: torch.as_tensor(v, device=dev) for k, v in grads.items()}

rows = []
for b in BUCKETS:
    sync = tree_mod.TreeSync(world, mean=False, bucket_bytes=b)
    world.barrier()
    sync.issue(grads).wait()  # warm programs + plan cache + channels
    best = None
    for _ in range(REPEATS):
        world.barrier()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        sync.issue(grads).wait()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    rows.append({"bucket": b, "seconds": best,
                 "transfers": tree_mod.plan_from_meta(
                     metas, b).n_transfers()})
world.barrier()
if me == 0:
    with open(os.environ["OMPITPU_LOOPBACK_OUT"], "w") as f:
        json.dump({"nprocs": world.size, "tree_bytes": int(total),
                   "leaves": len(grads), "rows": rows}, f)
mpi.finalize()
'''


def sweep_tree_buckets(nprocs: int, buckets: Sequence[int],
                       repeats: int = 3,
                       timeout_s: int = 600,
                       device="cuda:0") -> Optional[Dict]:
    """Time the planned whole-tree allreduce pass
    (``parallel/tree.TreeSync``) at each bucket capacity through a
    real ``nprocs``-process loopback ``tpurun`` job — the bucket size
    IS the tree planner's fusion threshold, so this sweep measures the
    fewer-collectives vs bigger-staging tradeoff on the exact wire
    path a job runs. ``0`` is always included (the per-leaf path the
    rules can pin with ``per_leaf``)."""
    import json as _json
    import os as _os

    from ..tools.tpurun import run_loopback_app

    cand = sorted({int(b) for b in buckets if int(b) > 0})
    out = run_loopback_app(
        nprocs,
        _TREE_TUNE_APP % {
            "repo": _os.path.dirname(_os.path.dirname(
                _os.path.dirname(_os.path.abspath(__file__))))},
        {"OMPITPU_TREE_TUNE_BUCKETS": _json.dumps([0] + cand),
         "OMPITPU_TREE_TUNE_REPEATS": str(repeats),
         "OMPITPU_TUNE_DEVICE": str(device)},
        "tree_tune.json", timeout_s=timeout_s)
    if out is None:
        _log.verbose(1, "tree-bucket sweep job failed")
    return out


def emit_tree_rules(sweep: Dict) -> str:
    """Render a tree-bucket sweep as a ``tree_buckets`` rule line the
    planner auto-selects (``parallel/tree.resolve_bucket_bytes``):
    algorithm ``fused`` with the winning capacity in the 5th column,
    or ``per_leaf`` when bucketing lost. Measurements (time and
    transfer count per candidate) ride in the justification comment,
    the same treatment as every other emitted rule."""
    if not sweep or not sweep.get("rows"):
        return ""
    rows = sweep["rows"]
    pts = ", ".join(
        f"{('per_leaf' if r['bucket'] == 0 else r['bucket'])}="
        f"{r['seconds'] * 1e3:.1f}ms/{r['transfers']}xfers"
        for r in sorted(rows, key=lambda r: r["seconds"]))
    best = min(rows, key=lambda r: r["seconds"])
    lines = [
        "",
        f"# tree_buckets: planned whole-tree pass, measured on a "
        f"{sweep['nprocs']}-process loopback job "
        f"({sweep['leaves']}-leaf {sweep['tree_bytes'] >> 10} KiB "
        f"tree, tpu-tune --tree-buckets); min_msg_bytes is TOTAL "
        f"tree bytes",
        f"#   {pts}",
    ]
    if best["bucket"] == 0:
        lines.append("tree_buckets  0  0  per_leaf")
    else:
        lines.append(f"tree_buckets  0  0  fused  {best['bucket']}")
    return "\n".join(lines) + "\n"


def sweep_hier(nprocs: int, ops: Sequence[str], sizes: Sequence[int],
               repeats: int = 3, timeout_s: int = 600,
               hosts_per: int = 0, device="cuda:0") -> Optional[Dict]:
    """Measure the spanning collectives' INTER schedules through a
    real ``nprocs``-process loopback ``tpurun`` job (the schedules
    only exist across process boundaries — a single-process sweep
    cannot time them). The menu comes from
    ``hier_schedules.ALGORITHMS``, so the topology-aware variants
    (multiring/torus2d) are swept too; ``hosts_per`` > 0 groups the
    processes into fake hosts of that size (distinct shm identities
    per group) so those variants see a real shm/DCN split. Returns
    ``{"nprocs", "hosts_per", "results"}`` in :func:`measure`'s row
    shape, or None if the job failed."""
    import json as _json
    import os as _os

    from ..tools.tpurun import run_loopback_app

    out = run_loopback_app(
        nprocs,
        _HIER_TUNE_APP % {
            "repo": _os.path.dirname(_os.path.dirname(
                _os.path.dirname(_os.path.abspath(__file__))))},
        {"OMPITPU_HIER_TUNE_OPS": _json.dumps(list(ops)),
         "OMPITPU_HIER_TUNE_SIZES": _json.dumps(
             sorted(int(s) for s in sizes)),
         "OMPITPU_HIER_TUNE_REPEATS": str(repeats),
         "OMPITPU_HIER_TUNE_HOSTS_PER": str(int(hosts_per)),
         "OMPITPU_TUNE_DEVICE": str(device)},
        "hier_tune.json", timeout_s=timeout_s)
    if out is None:
        _log.verbose(1, "hier sweep job failed")
    elif isinstance(out, dict):
        out.setdefault("hosts_per", int(hosts_per))
    return out


def emit_hier_rules(sweep: Dict) -> str:
    """Render a hier sweep as ``hier_<op>`` rule lines (same
    ascending-threshold last-match-wins shape as :func:`emit`, and the
    same min_comm_size=0 convention: the emitted rules apply at every
    process count, since one sweep measures one). The measured process
    count is recorded in the header comment — re-run at another
    ``--hier-procs`` and hand-scope the lines if your jobs vary."""
    if not sweep:
        return ""
    nprocs = int(sweep["nprocs"])
    lines = [
        "",
        f"# hier_* inter-process schedules, measured on a {nprocs}-"
        "process loopback job (tpu-tune --hier-procs); min_comm_size "
        "is the PROCESS count",
    ]
    for op, rows in sweep["results"].items():
        if not rows:
            continue
        prev = None
        for i, row in enumerate(rows):
            t = ", ".join(f"{a}={s * 1e6:.0f}us"
                          for a, s in sorted(row["times"].items(),
                                             key=lambda kv: kv[1]))
            lines.append(f"# hier_{op} @ {row['size']}B: {t}")
            if row["winner"] != prev:
                thresh = 0 if i == 0 else row["unit_bytes"]
                lines.append(
                    f"hier_{op}  0  {thresh}  {row['winner']}")
                prev = row["winner"]
    return "\n".join(lines) + "\n"


def measure(comm, ops: Sequence[str], sizes: Sequence[int],
            repeats: int = 5, *, segsizes: Optional[Sequence[int]] = None,
            algs: Optional[Sequence[str]] = None) -> Dict[str, List[Dict]]:
    """{op: [{size, unit_bytes, times: {alg: s}, compile: {alg: s},
    winner[, segsize, segsize_times]}]} — per-rank buffer sizes in
    bytes; min-of-repeats timing (dispatch latency spikes are
    one-sided). The first call per algorithm compiles AND primes the
    driver plan cache, so the measured repeats exclude compile time;
    the compile cost is reported separately in ``compile``. With
    ``segsizes``, pipeline-capable winners get a segment-size sweep
    (``segsize`` = best, 0 = monolithic won). ``algs`` restricts the
    algorithm menu (default: every legal algorithm of the op)."""
    if getattr(comm, "spans_processes", False):
        from ..utils.errors import ErrorCode, MPIError

        raise MPIError(
            ErrorCode.ERR_NOT_AVAILABLE,
            "tpu-tune measures the in-process compiled algorithms "
            "(driver-mode buffers); run it single-process on the "
            "target mesh shape — the rule file it emits applies to "
            "any job",
        )
    from ..coll import pipeline

    import torch

    n = comm.size
    dev = comm.device
    tuned = _tuned_dup(comm)
    # measure from scratch: an active rules file (a previous tuning
    # run) must not steer this one — the algorithm is pinned by the
    # forced cvar, and its segsize column would silently pipeline the
    # alg-phase timings (pick_segsize: rules > cvar). The ambient
    # coll_pipeline_segsize is pinned to 0 too: the alg phase times
    # MONOLITHIC algorithms (the segsize sweep's own 0-baseline), and
    # pipelining is explored only by the explicit sweep
    prev_rules = mca_var.get("coll_tuned_use_dynamic_rules", False)
    prev_seg = mca_var.get("coll_pipeline_segsize", 1 << 20)
    mca_var.set_value("coll_tuned_use_dynamic_rules", False)
    mca_var.set_value("coll_pipeline_segsize", 0)
    try:
        results: Dict[str, List[Dict]] = {}
        for op in ops:
            runner, unit_fn = _OPS[op]
            var = f"coll_tuned_{op}_algorithm"
            # restore the OPERATOR's forced value after each timing,
            # not the literal 'auto' — tpu-tune must not clobber a
            # deployment's pinned algorithm
            prev_alg = mca_var.get(var, "auto")
            rows = []
            for size in sizes:
                elems = max(n, size // 4)
                elems = -(-elems // n) * n  # alltoall/scatter: % n == 0
                x = torch.ones((n, elems), dtype=torch.float32,
                               device=dev)
                times: Dict[str, float] = {}
                compiles: Dict[str, float] = {}
                for alg in (algs or _algorithms(op)):
                    mca_var.set_value(var, alg)
                    try:
                        # compile + warm: this first call also primes
                        # the driver plan cache, so the repeats below
                        # never pay compile time
                        t_first = _time_once(runner, tuned, x)
                        times[alg] = min(
                            _time_once(runner, tuned, x)
                            for _ in range(repeats)
                        )
                        compiles[alg] = max(0.0, t_first - times[alg])
                    except Exception as e:
                        # an algorithm an op/shape cannot run (e.g.
                        # ring without identity) is skipped, not fatal
                        _log.verbose(2, f"{op}/{alg}@{size}: {e}")
                    finally:
                        mca_var.set_value(var, prev_alg)
                if not times:
                    continue
                winner = min(times, key=times.get)
                row = {
                    "size": size, "unit_bytes": unit_fn(elems * 4, n),
                    "times": times, "compile": compiles, "winner": winner,
                }
                pipe_alg = pipeline.PIPELINE_CAPABLE.get(op)
                pos_segs = [s for s in (segsizes or ()) if s > 0]
                if (pos_segs and winner == pipe_alg
                        and size > min(pos_segs)):
                    seg_times = sweep_segsizes(
                        tuned, op, winner, x, segsizes, repeats
                    )
                    if seg_times:
                        row["segsize_times"] = seg_times
                        row["segsize"] = min(seg_times, key=seg_times.get)
                rows.append(row)
            results[op] = rows
        return results
    finally:
        mca_var.set_value("coll_tuned_use_dynamic_rules", prev_rules)
        mca_var.set_value("coll_pipeline_segsize", prev_seg)
        tuned.free()


def _fixed_choice(comm, op: str, size: int) -> Optional[str]:
    """What the baked-in decision constants would pick (for the
    emitted differs-from-fixed annotations)."""
    import torch

    from .. import ops as ops_mod
    from ..coll import components as coll_components

    n = comm.size
    elems = max(n, size // 4)
    elems = -(-elems // n) * n
    x = torch.ones((n, elems), dtype=torch.float32,
                   device=comm.device)
    mod = coll_components._TunedModule(comm)
    # the pickers consult dynamic rules BEFORE the fixed constants —
    # when re-tuning an already-tuned deployment the annotation must
    # still compare against the constants, not the old rule file
    prev = mca_var.get("coll_tuned_use_dynamic_rules", False)
    mca_var.set_value("coll_tuned_use_dynamic_rules", False)
    try:
        if op == "allreduce":
            return mod._pick_allreduce(x, ops_mod.SUM)
        if op == "bcast":
            return mod._pick_bcast(x)[0]
        if op == "reduce":
            return mod._pick_reduce(x, ops_mod.SUM)
        if op == "allgather":
            return mod._pick_allgather(x)
        if op == "alltoall":
            return mod._pick_alltoall(x)
    except Exception:
        pass
    finally:
        mca_var.set_value("coll_tuned_use_dynamic_rules", prev)
    return None


def _device_kind(comm) -> str:
    """The device the comm's ranks live on, by name."""
    import torch

    dev = torch.device(comm.device)
    if dev.type == "cuda":
        return f"{torch.cuda.get_device_name(dev)} (cuda)"
    return "cpu"


def emit(comm, results: Dict[str, List[Dict]]) -> str:
    """Render measurements as a dynamic rule file: ascending
    min_msg_bytes lines per op (LAST match wins, so each line is the
    threshold where the winner changes), every rule justified by its
    measurements in a comment."""
    lines = [
        "# generated by tpu-tune — measured algorithm selection",
        f"# mesh: {comm.size} virtual ranks of {_device_kind(comm)}, "
        f"comm size {comm.size}",
        "# load with: --mca coll_tuned_use_dynamic_rules 1 "
        "--mca coll_tuned_dynamic_rules_filename <this file>",
        "#",
        "# collective  min_comm_size  min_msg_bytes  algorithm  [segsize]",
    ]
    for op, rows in results.items():
        if not rows:
            continue
        lines.append("")
        prev = None
        for i, row in enumerate(rows):
            t = ", ".join(f"{a}={s * 1e6:.0f}us"
                          for a, s in sorted(row["times"].items(),
                                             key=lambda kv: kv[1]))
            fixed = _fixed_choice(comm, op, row["size"])
            note = (f"  [differs from fixed constants: {fixed}]"
                    if fixed is not None
                    and fixed != row["winner"] else "")
            lines.append(f"# {op} @ {row['size']}B/rank: {t}{note}")
            if row.get("compile"):
                c = ", ".join(
                    f"{a}={s * 1e3:.0f}ms"
                    for a, s in sorted(row["compile"].items(),
                                       key=lambda kv: kv[1]))
                lines.append(f"#   compile: {c}")
            if row.get("segsize_times"):
                st = ", ".join(
                    f"{('off' if k == 0 else k)}={v * 1e6:.0f}us"
                    for k, v in sorted(row["segsize_times"].items(),
                                       key=lambda kv: kv[1]))
                lines.append(
                    f"#   segsize sweep ({row['winner']}): {st}"
                )
            pick = (row["winner"], row.get("segsize"))
            if pick != prev:
                thresh = 0 if i == 0 else row["unit_bytes"]
                seg_col = ("" if row.get("segsize") is None
                           else f"  {row['segsize']}")
                lines.append(
                    f"{op}  0  {thresh}  {row['winner']}{seg_col}"
                )
                prev = pick
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu-tune",
        description="Measure collective algorithms on this mesh and "
                    "emit a dynamic rules file",
    )
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--sizes", default="1024,65536,1048576,16777216",
                    help="comma-separated per-rank buffer sizes (bytes)")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--ops", default="allreduce,bcast,reduce,"
                                     "allgather,alltoall")
    ap.add_argument("--segsizes", default="65536,262144,1048576",
                    help="comma-separated pipeline segment sizes to "
                         "sweep for pipeline-capable winners (emits "
                         "the segsize rule column); empty disables")
    ap.add_argument("--wire-segsizes", default="",
                    help="comma-separated wire_pipeline_segsize values "
                         "to sweep through a loopback OOB staged "
                         "transfer (emits a recommendation comment); "
                         "empty disables")
    ap.add_argument("--hier-procs", type=int, default=0,
                    help="process count for the spanning-collective "
                         "INTER schedule sweep (a real loopback tpurun "
                         "job; emits hier_* rule lines); 0 disables")
    ap.add_argument("--hier-ops", default="allreduce,bcast,reduce,"
                                          "allgather,alltoall",
                    help="spanning collectives the hier sweep times")
    ap.add_argument("--hier-sizes", default="1024,65536,1048576",
                    help="per-rank buffer sizes (bytes) for the hier "
                         "sweep")
    ap.add_argument("--hier-hosts-per", type=int, default=0,
                    help="group the hier sweep's processes into fake "
                         "hosts of this size (distinct shm identities) "
                         "so the topology-aware schedules (multiring/"
                         "torus2d) measure over a real shm/DCN split; "
                         "0 keeps the machine's own host identity")
    ap.add_argument("--db", default="",
                    help="register the emitted rules file into this "
                         "tuning-database directory (a new versioned, "
                         "fingerprint-stamped entry jobs auto-select "
                         "via --mca coll_tuning_db_dir); empty "
                         "disables")
    ap.add_argument("--tree-buckets", default="",
                    help="comma-separated bucket capacities (bytes) to "
                         "sweep for the planned whole-tree pass "
                         "(parallel/tree) through a loopback tpurun "
                         "job; emits a tree_buckets rule line the "
                         "planner auto-selects; empty disables")
    ap.add_argument("--tree-procs", type=int, default=3,
                    help="process count for the tree-bucket sweep job")
    ap.add_argument("--ranks", type=int, default=8,
                    help="virtual ranks of the device the in-process "
                         "sweep runs on (the comm size)")
    ap.add_argument("--device", default="cuda:0",
                    help="the device every sweep runs on (cuda:0 by "
                         "default; cpu on the host)")
    args = ap.parse_args(argv)

    import ompi_release_tpu_torch as mpi

    comm = mpi.init(cli_args=["--mca", "runtime_virtual_ranks",
                              str(args.ranks)], device=args.device)
    # ascending is load-bearing: emit() writes threshold lines in row
    # order and dynamic_rules takes the LAST match
    sizes = sorted(int(s) for s in args.sizes.split(",") if s)
    ops = [o.strip() for o in args.ops.split(",") if o.strip()]
    segsizes = sorted(int(s) for s in args.segsizes.split(",") if s)
    results = measure(comm, ops, sizes, repeats=args.repeats,
                      segsizes=segsizes or None)
    text = emit(comm, results)
    wire_segs = sorted(int(s) for s in args.wire_segsizes.split(",")
                       if s.strip())
    if wire_segs:
        text += emit_wire_rules(sweep_wire_segsizes(wire_segs)) + "\n"
    if args.hier_procs >= 2:
        hier_ops = [o.strip() for o in args.hier_ops.split(",")
                    if o.strip()]
        hier_sizes = sorted(int(s) for s in args.hier_sizes.split(",")
                            if s.strip())
        sweep = sweep_hier(args.hier_procs, hier_ops, hier_sizes,
                           repeats=args.repeats,
                           hosts_per=args.hier_hosts_per,
                           device=args.device)
        if sweep:
            text += emit_hier_rules(sweep)
    tree_buckets = [int(s) for s in args.tree_buckets.split(",")
                    if s.strip()]
    if tree_buckets:
        tsweep = sweep_tree_buckets(args.tree_procs, tree_buckets,
                                    repeats=args.repeats,
                                    device=args.device)
        if tsweep:
            text += emit_tree_rules(tsweep)
    # every emitted file is stamped with the MEASURED topology
    # fingerprint — the tuning-db selection key, and honest provenance
    # even for hand-pointed files
    fp = measured_fingerprint(args.hier_procs, args.hier_hosts_per)
    text = tuning_db.stamp(text, fp)
    with open(args.output, "w") as f:
        f.write(text)
    # validate what we just wrote parses (a typo'd generator must not
    # hand the operator a file that fails at job start)
    from ..coll import dynamic_rules

    dynamic_rules.load_rules(args.output)
    n_rules = sum(1 for ln in text.splitlines()
                  if ln and not ln.startswith("#"))
    print(f"tpu-tune: wrote {n_rules} rule(s) to {args.output} "
          f"[fingerprint {fp.canon()}]")
    if args.db:
        path = tuning_db.TuningDb(args.db).register(text, fp)
        print(f"tpu-tune: registered into tuning db: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
