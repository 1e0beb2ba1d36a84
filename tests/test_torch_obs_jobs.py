"""The port's observability plane over real ``tpurun`` jobs, asserting
the findings of the JAX package's job tests, and the JAX package's
doctor run on the port's dumps agrees with the port's.

- the hang-injection job (``tests/test_doctor.py:523``) with the fleet
  series (``tests/test_metrics_plane.py:1183``) and ``tpu_ps``: 3
  workers x 2 virtual ranks, worker 1 sleeps 4 s before an allreduce;
  the others' watchdogs dump a postmortem naming the allreduce and the
  absent ranks; finalize writes the journal, series, ledger and
  nativeev dumps; the merged trace has cross-process hier and wire
  flows and paired native fragment flows; the report names worker 1;
  the HNP holds every worker's series pushes; worker 0 lists the live
  job through ``tpu_ps``;
- the desync job: inline (``obs_sentinel=2``): worker 1 posts a f64
  allreduce where the others post f32, and every worker raises
  ERR_COLL_MISMATCH in that round, naming the divergent process and
  both call sites (``tests/test_sentinel.py:532``); a late worker 1
  under the inline check: the others' watchdogs name the allreduce and
  worker 1's ranks, and their round's coll span holds the wait; then
  post hoc
  (``obs_sentinel=1``): worker 2 swaps an ibarrier / iallreduce pair,
  the job hangs, the postmortems' signature rings give ``tpu-doctor
  contracts`` the posting-order swap (``:604``).
"""

import io
import json
import os
import sys
import textwrap

import pytest

from ompi_release_tpu.obs import doctor as jdoctor
from ompi_release_tpu_torch.obs import doctor as tdoctor
from ompi_release_tpu_torch.obs import export as texport
from ompi_release_tpu_torch.runtime.state import JobState
from ompi_release_tpu_torch.tools.tpurun import Job

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = textwrap.dedent("""
    import json, os, sys, threading, time
    sys.path.insert(0, %(repo)r)
    import numpy as np
    import torch
    import ompi_release_tpu_torch as mpi
    from ompi_release_tpu_torch import obs
    from ompi_release_tpu_torch.mca import var as mca_var
    from ompi_release_tpu_torch.obs import nativeev, sampler, sentinel
    from ompi_release_tpu_torch.obs import watchdog as wd
    from ompi_release_tpu_torch.runtime.runtime import Runtime
    from ompi_release_tpu_torch.utils.errors import ErrorCode, MPIError

    world = mpi.init(cli_args=["--mca", "runtime_virtual_ranks", "2"],
                     device="cpu")
    rt = Runtime.current()
    me = rt.bootstrap["process_index"]
""")

HANG_BODY = textwrap.dedent("""
    assert obs.enabled and wd.enabled and sampler.SAMPLER.running()
    assert nativeev.get_ring() is not None and obs.clock_offset() is not None
    if me == 0:
        from ompi_release_tpu_torch.tools import tpu_ps
        jobs = [j for j in tpu_ps.discover_jobs()
                if int(j.get("pid", -1)) == os.getppid()]
        t_end = time.monotonic() + 10
        while True:
            cl = tpu_ps.PsClient(jobs[0]["host"], int(jobs[0]["port"]),
                                 secret=jobs[0].get("secret"))
            try:
                snap = cl.query()
            finally:
                cl.close()
            if all(r.get("rss") for r in snap["workers"].values()) \\
                    or time.monotonic() > t_end:
                break
            time.sleep(0.2)
        print("PS " + json.dumps(snap), flush=True)
    if me == 1:
        time.sleep(%(delay)s)   # the straggler every other rank waits on
    x = torch.stack([torch.arange(256, dtype=torch.int32)
                     * (rt.local_rank_offset + i + 1) for i in range(2)])
    got = world.allreduce(x)
    want = sum(np.arange(256, dtype=np.int32) * (r + 1)
               for r in range(world.size))
    np.testing.assert_array_equal(got[0].numpy(), want)
    y = torch.ones((2, 1 << 15), dtype=torch.float32)
    for _ in range(6):          # span several sampler ticks
        world.allreduce(y)
        time.sleep(0.12)
    # a replayed fire leaves what the interpreted one journaled, as one
    # ledger record: its expansion has the same message spans
    import collections
    from ompi_release_tpu_torch.obs import ledger

    def mine(since):
        return [s.asdict() for s in obs.journal.snapshot()
                if s.seq >= since and s.comm_id == world.cid]

    def msgs(spans):
        return sorted(collections.Counter(
            (s["op"], s["peer"]) for s in spans
            if s["op"] in ("hier_send", "hier_recv")).items())

    z = torch.ones((2, 3000), dtype=torch.float32)
    r0 = max([r["seq"] for r in ledger.records()], default=-1)
    s0 = obs.journal.total_recorded
    world.allreduce(z)
    interp = mine(s0)
    s1 = obs.journal.total_recorded
    world.allreduce(z)
    replay = mine(s1)
    recs = [r for r in ledger.records(r0)
            if r["kind"] == ledger.KIND_SPANNING and r["cid"] == world.cid]
    plans = {str(k): v for k, v in ledger.plans().items()}
    print("RECORDS " + json.dumps({
        "interp": msgs(interp), "replay": msgs(replay), "n": len(recs),
        "expanded": msgs(ledger.expand_record(recs[0], plans, me)),
        "coll": [sum(1 for s in sp if s["layer"] == "coll")
                 for sp in (interp, replay)]}), flush=True)
    if me == 0:
        world.send(torch.arange(512, dtype=torch.float32), 3, tag=7, rank=1)
    elif me == 1:
        v, st = world.recv(source=1, tag=7, rank=3)
        np.testing.assert_array_equal(v.numpy(), np.arange(512,
                                                           dtype=np.float32))
    world.barrier()
    print(f"HANG-APP-OK {me}", flush=True)
    mpi.finalize()
""")

DESYNC_BODY = textwrap.dedent("""
    assert obs.enabled and sentinel.mode() == 2 and wd.enabled
    x32 = torch.ones((2, 64), dtype=torch.float32)
    x64 = torch.ones((2, 64), dtype=torch.float64)
    got = world.allreduce(x32)
    np.testing.assert_allclose(got[0].numpy(), 6.0)
    try:
        if me == 1:
            world.allreduce(x64)   # the desync: float64 where others f32
        else:
            world.allreduce(x32)
        print(f"SENTINEL-NO-RAISE {me}", flush=True)
    except MPIError as e:
        assert e.code == ErrorCode.ERR_COLL_MISMATCH, e
        print(f"SENTINEL-MISMATCH-OK {me} :: {e}", flush=True)
    got = world.allreduce(x32)
    np.testing.assert_allclose(got[0].numpy(), 6.0)
    world.barrier()
    print(f"SENTINEL-APP-DONE {me}", flush=True)

    # a late worker under the inline check: the wait in the signature
    # exchange is the round's
    mca_var.set_value("obs_postmortem_dir", %(late_pm)r)
    if me == 1:
        time.sleep(3.2)
    s0 = obs.journal.total_recorded
    world.allreduce(x32)
    spans = [s.dt for s in obs.journal.snapshot()
             if s.seq >= s0 and s.layer == "coll" and s.op == "allreduce"
             and s.comm_id == world.cid]
    print("LATE " + json.dumps({"me": me, "dt": spans}), flush=True)
    mca_var.set_value("obs_postmortem_dir", %(pm)r)

    # post hoc: a posting-order swap the watchdog postmortems capture
    mca_var.set_value("obs_sentinel", 1)
    sentinel.refresh()

    def bail():
        time.sleep(%(bail_s)s)
        print(f"SWAP-APP-BAIL {me}", flush=True)
        os._exit(9)

    threading.Thread(target=bail, daemon=True).start()
    sub = world.dup(name="swap")  # a comm of its own: a chain of its own
    x = torch.ones((2, 32), dtype=torch.float32)
    sub.allreduce(x)              # a healthy aligned round first
    if me == 2:
        r1 = sub.iallreduce(x)    # the swap: allreduce posted BEFORE the
        r2 = sub.ibarrier()       # barrier workers 0/1 posted first
    else:
        r1 = sub.ibarrier()
        r2 = sub.iallreduce(x)
    r1.wait()
    r2.wait()
    print(f"SWAP-APP-UNEXPECTED-FINISH {me}", flush=True)
    mpi.finalize()
""")


def _job(tmp_path, name, body, mca, subs):
    app = tmp_path / f"{name}.py"
    app.write_text(PRELUDE % {"repo": REPO} + body % subs)
    job = Job(3, [sys.executable, str(app)], mca, heartbeat_s=0.5,
              miss_limit=20)
    rc = job.run(timeout_s=180)
    return rc, job


@pytest.fixture(scope="module")
def hang_job(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs_hang")
    pm, dumps = tmp / "pm", tmp / "dumps"
    keep = sys.stdout
    # the launcher forwards the workers' lines to its sys.stdout
    buf = io.StringIO()
    sys.stdout = buf
    try:
        rc, job = _job(tmp, "hang_app", HANG_BODY,
                       [("obs_enable", "1"), ("obs_stall_timeout", "1.2"),
                        ("obs_postmortem_dir", str(pm)),
                        ("obs_dump_dir", str(dumps)),
                        ("obs_sample_interval", "0.1"),
                        ("btl_nativewire_events", "1")],
                       {"delay": 4.0})
    finally:
        sys.stdout = keep
    return rc, job, buf.getvalue(), pm, dumps


def test_hang_job_postmortem_names_the_wait(hang_job):
    rc, job, out, pm, _ = hang_job
    assert rc == 0, out
    assert job.job_state.visited(JobState.TERMINATED)
    pms = sorted(pm.glob("postmortem-*-stall-*.json"))
    assert pms, f"no stall postmortem in {pm}"
    named = False
    for p in pms:
        doc = json.loads(p.read_text())
        for s in doc.get("stalled", []):
            info = s.get("info") or {}
            if s["op"] == "allreduce" and (
                    1 in (info.get("awaiting_procs") or [])
                    or {2, 3} & set(info.get("awaiting_ranks") or [])):
                named = True
                assert any(st.get("op") == "allreduce"
                           for st in doc["hier_rounds"].values())
        for key in ("journal_tail", "ledger_tail", "sentinel",
                    "frozen_plans", "native_rings", "nbc_inflight",
                    "hier_rounds", "ft_state", "msg_queues"):
            assert key in doc and not isinstance(doc[key], str), key
    assert named


def test_hang_job_merged_trace_and_report(hang_job):
    _, _, _, _, dumps = hang_job
    for kind, ext in (("journal", "json"), ("series", "jsonl"),
                      ("ledger", "json"), ("nativeev", "json")):
        assert len(list(dumps.glob(f"{kind}-p*.{ext}"))) == 3, kind
    ds = tdoctor.load_dir(str(dumps))
    assert len(ds) == 3
    assert all(d["meta"]["clock_offset_s"] is not None for d in ds)
    pairs = tdoctor.flow_pairs(ds)
    cross = [p for p in pairs if p["cross_process"]]
    assert any(p["src"]["op"] == "wire_send" and p["dst"]["op"] == "wire_recv"
               for p in cross)
    assert any(p["src"]["op"] == "hier_send" for p in cross)
    assert any(p["src"].get("nativeev") for p in pairs)
    trace = tdoctor.merge(ds)
    assert trace["otherData"]["processes"] == 3
    assert trace["otherData"]["cross_process_flows"] >= 1
    text, data = tdoctor.skew_report(ds)
    ar = max((r for r in data["rounds"] if r["op"] == "allreduce"),
             key=lambda r: r["spread_s"])
    assert ar["slowest_pidx"] == 1 and ar["spread_s"] > 2.0, text


def test_replayed_fire_leaves_the_interpreted_records(hang_job):
    _, _, out, _, _ = hang_job
    rows = [json.loads(ln.split("RECORDS ", 1)[1]) for ln in out.splitlines()
            if "RECORDS {" in ln]
    assert len(rows) == 3, out[-2000:]
    for r in rows:
        # the interpreted fire's coll spans include the native compile's
        # two wire-free probe runs of the schedule
        assert r["n"] == 1 and r["replay"] == [] and r["coll"][1] == 1, r
        assert r["coll"][0] in (1, 3), r
        assert r["interp"] and r["expanded"] == r["interp"], r


def test_jax_doctor_reads_the_ports_dumps(hang_job):
    """The dump formats are shared: the JAX package's doctor gives the
    port's doctor's reports on the port's dumps."""
    _, _, _, _, dumps = hang_job
    d = str(dumps)
    t = tdoctor.load_dir(d)
    j = jdoctor.load_dir(d)
    assert tdoctor.merge(t) == jdoctor.merge(j)
    ts, js = tdoctor.load_series_dir(d), jdoctor.load_series_dir(d)
    assert tdoctor.skew_report(t, series=ts) == \
        jdoctor.skew_report(j, series=js)
    assert tdoctor.contract_report(t) == jdoctor.contract_report(j)


def test_hang_job_fleet_series_and_ps(hang_job):
    _, job, out, _, dumps = hang_job
    docs = tdoctor.load_series_dir(str(dumps))
    assert len(docs) == 3 and all(d["points"] for d in docs)
    merged = tdoctor.merge_series(docs)
    assert {p["pidx"] for p in merged} == {0, 1, 2}
    for pidx in (0, 1, 2):
        ops = sum(p["v"] for p in merged
                  if p["pidx"] == pidx and p["name"] == "coll_ops")
        assert ops >= 6, (pidx, ops)
    fleet = job.hnp.fleet_series()
    assert set(fleet["procs"]) == {"0", "1", "2"}
    assert all(e["points"] for e in fleet["procs"].values())
    text, data = tdoctor.skew_report(tdoctor.load_dir(str(dumps)),
                                     series=docs)
    assert "sampled rates" in text
    om = texport.openmetrics_series(docs[0]["points"], pidx=0)
    assert om.endswith("# EOF\n") and 'pidx="0"' in om
    ps = [json.loads(ln.split("PS ", 1)[1]) for ln in out.splitlines()
          if "PS {" in ln]
    assert ps, out[-2000:]
    snap = ps[0]
    assert set(snap["workers"]) == {"1", "2", "3"}
    assert all(r.get("pid") and r.get("rss") for r in
               snap["workers"].values()), snap
    assert set(snap["proc_states"]) == {"1", "2", "3"}


def test_desync_job_inline_then_posthoc(tmp_path, capfd):
    pm, late_pm = tmp_path / "pm", tmp_path / "pm_late"
    rc, _job_ = _job(tmp_path, "desync_app", DESYNC_BODY,
                     [("obs_enable", "1"), ("obs_sentinel", "2"),
                      ("obs_stall_timeout", "1.5"),
                      ("obs_postmortem_dir", str(pm))],
                     {"bail_s": 9.0, "pm": str(pm),
                      "late_pm": str(late_pm)})
    out = capfd.readouterr().out
    assert rc != 0, "a desynced job must not exit clean"
    for me in (0, 1, 2):
        assert f"SENTINEL-MISMATCH-OK {me}" in out, out
        assert f"SENTINEL-APP-DONE {me}" in out
    assert "SENTINEL-NO-RAISE" not in out
    assert "SWAP-APP-UNEXPECTED-FINISH" not in out
    mis = [ln for ln in out.splitlines() if "SENTINEL-MISMATCH-OK 0" in ln]
    assert mis and "ERR_COLL_MISMATCH" in mis[0] and "process 1" in mis[0]
    assert "float64" in mis[0] and "float32" in mis[0]
    assert mis[0].count("desync_app.py:") == 2, mis[0]

    late = {r["me"]: r["dt"] for r in
            (json.loads(ln.split("LATE ", 1)[1]) for ln in out.splitlines()
             if "LATE {" in ln)}
    assert set(late) == {0, 1, 2} and all(len(v) == 1 for v in late.values())
    assert late[0][0] > 2.5 and late[2][0] > 2.5 and late[1][0] < 1.0, late
    named = [s for p in late_pm.glob("postmortem-*-stall-*.json")
             for s in json.loads(p.read_text()).get("stalled", [])
             if s["op"] == "allreduce"
             and 1 in (s.get("info") or {}).get("awaiting_procs", [])
             and {2, 3} <= set((s.get("info") or {})
                               .get("awaiting_ranks", []))]
    assert named, sorted(late_pm.iterdir())

    dumps = tdoctor.load_dir(str(pm))
    text, data = tdoctor.contract_report(dumps, directory=str(pm))
    assert (text, data) == jdoctor.contract_report(
        jdoctor.load_dir(str(pm)), directory=str(pm))
    # world: the inline round's mismatch (worker 1's f64); the swap's
    # comm: the posting-order swap
    divs = {cid: c["divergence"] for cid, c in data["comms"].items()
            if c["divergence"]}
    assert data["divergences"] == 2 and set(divs) - {"0"}, (divs, text)
    assert divs["0"]["kind"] == "signature_mismatch"
    assert divs["0"]["divergent"] == 1
    div = next(d for cid, d in divs.items() if cid != "0")
    assert div["kind"] == "posting_order_swap", (div, text)
    assert div["divergent"] == 2
    assert text.count("desync_app.py:") >= 2, text
    assert div["expected"]["canon"].startswith("barrier|")
    assert div["actual"]["canon"].startswith("allreduce|")
    from ompi_release_tpu_torch.tools.tpu_doctor import main as doctor_main

    assert doctor_main(["contracts", str(pm)]) == 3
    assert "posting-order swap" in capfd.readouterr().out
