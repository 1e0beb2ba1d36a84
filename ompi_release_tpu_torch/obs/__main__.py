"""``python -m ompi_release_tpu_torch.obs`` — observability selftest.

``--selftest`` registers one pvar of every class, bumps each, drives
the journal through a ring wrap, runs a skew-timer cycle, exports
through every exporter, and verifies the round-trip — device-free and
fast, so the tier-1 suite can run it as a subprocess smoke test.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def selftest() -> int:
    from ..mca import mpit, pvar
    from . import disable, enable, flow_id, journal
    from . import export, skew

    # 1. every pvar class: register, bump, read
    c = pvar.counter("obs_selftest_counter", "selftest")
    c.add(2)
    t = pvar.timer("obs_selftest_timer", "selftest")
    with t.timing():
        pass
    hw = pvar.highwatermark("obs_selftest_hwm", "selftest")
    hw.set(5)
    hw.set(3)
    assert hw.read() == 5, "highwatermark must keep the max"
    hist = pvar.histogram("obs_selftest_hist", "selftest")
    for v in (0.0, 1e-4, 3.0, 4.0, 1024.0):
        hist.observe(v)
    snap = hist.read()
    assert snap["count"] == 5 and snap["max"] == 1024.0, snap
    assert sum(snap["buckets"].values()) == 5, snap
    agg = pvar.aggregate("obs_selftest_agg", "selftest")
    agg.observe(2.0)
    agg.observe(-1.0)
    a = agg.read()
    assert a["count"] == 2 and a["min"] == -1.0 and a["max"] == 2.0, a

    # 2. MPI_T session round-trip: session-relative deltas per class
    sess = mpit.Mpit().pvar_session()
    hc = sess.handle("obs_selftest_counter")
    hc.start()
    c.add(3)
    assert hc.read() == 3.0, hc.read()
    hh = sess.handle("obs_selftest_hist")
    hh.start()
    hist.observe(7.0)
    d = hh.read()
    assert d["count"] == 1.0 and d["sum"] == 7.0, d
    assert sum(d["buckets"].values()) == 1.0, d
    ha = sess.handle("obs_selftest_agg")
    ha.start()
    ha.reset()
    assert ha.read()["count"] == 0.0
    sess.free()

    # 3. journal ring wrap + skew cycle
    enable(size=8)
    for i in range(12):
        journal.record(f"op{i}", "selftest", time.perf_counter(), 1e-5,
                       nbytes=i)
    spans = journal.snapshot()
    assert len(spans) == 8 and spans[-1].op == "op11", spans
    assert spans[0].seq < spans[-1].seq
    # flow context round-trip: deterministic id, side survives asdict
    fid = flow_id("selftest", 1, 2)
    assert fid == flow_id("selftest", 1, 2) and fid != flow_id("x")
    journal.record("flow_s", "selftest", time.perf_counter(), 1e-6,
                   flow=fid, flow_side="s")
    fs = journal.snapshot()[-1]
    assert fs.flow == fid and fs.asdict()["fs"] == "s", fs.asdict()
    tok = skew.begin("selftest")
    skew.body(tok)
    skew.end(tok, nbytes=64)
    sk = pvar.PVARS.lookup("coll_selftest_skew_seconds")
    assert sk is not None and sk.read()["count"] == 1

    # 4. exporters round-trip
    with tempfile.TemporaryDirectory() as td:
        tp = export.dump_chrome_trace(os.path.join(td, "trace.json"))
        with open(tp) as f:
            doc = json.load(f)
        evs = [e for e in doc["traceEvents"] if e.get("ph") != "M"]
        assert evs, "chrome trace has no events"
        assert all("name" in e and "ts" in e and "ph" in e for e in evs)
        jp = export.dump_jsonl(os.path.join(td, "journal.jsonl"))
        with open(jp) as f:
            lines = [json.loads(line) for line in f]
        assert len(lines) == len(journal.snapshot())
        assert lines[-1]["op"] == "selftest"
    page = export.prometheus_text()
    for needle in (
        "ompitpu_obs_selftest_counter 5",
        "ompitpu_obs_selftest_hist_bucket",
        "ompitpu_obs_selftest_hist_count 6",
        "ompitpu_obs_selftest_agg_min -1",
        "ompitpu_coll_selftest_skew_seconds_count 1",
        "ompitpu_obs_journal_events",
    ):
        assert needle in page, f"{needle!r} missing from exposition"

    # 5. continuous sampler: delta snapshots, per-cid scoping, the
    # OpenMetrics-with-timestamps exposition, and the overhead pvar
    from . import sampler as _sampler

    _sampler._reset_for_tests()
    sc = pvar.counter("obs_selftest_series_ctr", "selftest")
    base_pts = _sampler.SAMPLER.sample_once()  # baseline tick
    assert base_pts >= 0
    sc.add(4)
    hist.observe(9.0)
    journal.record("allreduce", "coll", time.perf_counter(), 2e-3,
                   nbytes=1024, comm_id=7)
    n = _sampler.SAMPLER.sample_once()
    assert n > 0, "second tick must record deltas"
    pts = _sampler.snapshot()
    by_name = {}
    for p in pts:
        by_name.setdefault(p["name"], []).append(p)
    assert any(p["v"] == 4.0 for p in by_name["obs_selftest_series_ctr"])
    assert any(p["cid"] == 7 for p in by_name.get("coll_ops", [])), (
        "per-communicator coll series missing")
    ov = pvar.PVARS.lookup("obs_sample_overhead_seconds")
    assert ov is not None and float(ov.read()) > 0.0
    assert float(pvar.PVARS.lookup("obs_series_points").read()) >= n
    om = export.openmetrics_series(pts)
    assert om.endswith("# EOF\n") and "ompitpu_" in om
    assert 'cid="7"' in om, om[:400]
    # percentile math: all mass in one log2 bucket -> its midpoint
    est = _sampler.percentile({8.0: 10}, 0.5)
    assert est is not None and 4.0 < est <= 8.0, est
    # series dump/reload round-trip (the finalize-dump unit)
    with tempfile.TemporaryDirectory() as td:
        sp = export.dump_series_jsonl(os.path.join(td, "series-p0.jsonl"))
        from . import doctor as _doctor_mod

        doc = _doctor_mod.load_series_dump(sp)
        assert len(doc["points"]) == len(pts)
    print(f"sampler: {len(pts)} points "
          f"(overhead {float(ov.read()) * 1e3:.3f} ms)")

    # 6. collective contract sentinel: hash-chain determinism across
    # two identical op sequences, divergence detected on the third,
    # and the journal-event round-trip the doctor's contracts
    # alignment parses
    from ..mca import var as _var
    from . import sentinel as _sentinel

    _sentinel._reset_for_tests()
    _var.set_value("obs_sentinel", 1)
    _sentinel.refresh(True)
    assert _sentinel.enabled and _sentinel.mode() == 1
    seqs = (("allreduce", "sum", "float32", 1024, -1),
            ("bcast", "-", "float32", 1024, 0),
            ("reduce", "max", "int32", 64, 2))
    for cid in (101, 102):
        for fam, op_n, dt, cnt, root in seqs:
            _sentinel.record_sig(cid, fam, op_n, dt, cnt, root,
                                 site="selftest.py:1")
    assert _sentinel.chain_of(101) == _sentinel.chain_of(102) != 0, (
        "identical op sequences must fold to identical chains")
    _sentinel.record_sig(101, "allreduce", "sum", "float64", 1024, -1,
                         site="selftest.py:2")
    _sentinel.record_sig(102, "allreduce", "sum", "float32", 1024, -1,
                         site="selftest.py:2")
    assert _sentinel.chain_of(101) != _sentinel.chain_of(102), (
        "divergent third op must split the chains")
    last = [s for s in journal.snapshot() if s.layer == "sentinel"][-1]
    parsed = _sentinel.parse_op(last.op)
    assert parsed is not None and parsed["site"] == "selftest.py:2"
    assert parsed["canon"] == "allreduce|sum|float32|1024|-1", parsed
    snap = _sentinel.chains_snapshot()
    assert snap["comms"]["101"]["next_seq"] == 4
    assert float(pvar.PVARS.lookup("sentinel_ops_hashed").read()) >= 8
    _var.VARS.unset("obs_sentinel")
    _sentinel.refresh(True)
    assert not _sentinel.enabled
    print("sentinel: chain determinism + divergence detection ok "
          f"(chain {snap['comms']['101']['chain']})")

    # 7. coll driver plan-cache statistics (registered at driver
    # import; sum = hits, count = invocations → sum/count = hit ratio)
    from ..coll import driver as _coll_driver  # noqa: F401

    pc = pvar.PVARS.lookup("coll_plan_cache_hits")
    assert pc is not None, "coll driver must register coll_plan_cache_hits"
    st = pc.read()
    hits, total = int(st["sum"]), int(st["count"])
    ratio = (hits / total) if total else 0.0
    print(f"plan cache: {hits}/{total} hits "
          f"(ratio {ratio:.2f}; compiled="
          f"{pvar.PVARS.lookup('coll_programs_compiled').read():.0f}, "
          f"invocations="
          f"{pvar.PVARS.lookup('coll_invocations').read():.0f})")

    # 8. pytree planned-collective plan cache (parallel/tree): an
    # identical tree signature must fetch the cached plan (1=hit), a
    # different bucket capacity must build a fresh one (0), and the
    # counts are operator-visible here
    from ..parallel import tree as _tree

    sig = [((64, 64), "float32"), ((17,), "float32"), ((8,), "int32")]
    tp1 = _tree.plan_from_meta(sig, 1 << 20)
    assert _tree.plan_from_meta(sig, 1 << 20) is tp1, (
        "identical tree signatures must fetch the cached plan")
    assert _tree.plan_from_meta(sig, 1 << 4) is not tp1
    tc = pvar.PVARS.lookup("tree_plan_cache_hits")
    assert tc is not None, "parallel/tree must register tree_plan_cache_hits"
    ts = tc.read()
    assert ts["count"] >= 3 and ts["sum"] >= 1, ts
    print(f"tree plan cache: {int(ts['sum'])}/{int(ts['count'])} hits "
          f"({pvar.PVARS.lookup('tree_buckets_planned').read():.0f} "
          f"buckets planned)")

    # 9. compiled-schedule plan cache (coll/plan): signatures are
    # stable metadata (identical calls share a plan, different shapes
    # do not), frozen frame templates round-trip through the DSS wire
    # format the receivers parse, and the hit ratio is operator-
    # visible here — all device-free (no jax dispatch)
    import numpy as _np

    from ..btl import components as _btlc
    from ..coll import plan as _plan
    from ..native import DssBuffer as _Dss

    s1 = _plan.signature_of("allreduce", (_np.zeros((4, 8), _np.float32),),
                            {})
    s2 = _plan.signature_of("allreduce", (_np.zeros((4, 8), _np.float32),),
                            {})
    s3 = _plan.signature_of("allreduce", (_np.zeros((4, 9), _np.float32),),
                            {})
    assert s1 == s2 and s1 != s3, (s1, s3)
    assert _plan.signature_of("allgatherv",
                              ([_np.zeros(3)], [_np.zeros(2)]),
                              {}) is None, "ragged lists must not plan"
    tpl = _btlc.plan_frame_template((16, 16), "float32", 256)
    hdr = _Dss(tpl.header(xfer=9, crc=12345))
    assert hdr.unpack_string() == "SGH2"
    assert hdr.unpack_int64() == [9]
    assert hdr.unpack_string() == "float32"
    assert hdr.unpack_string() == "16,16"
    assert hdr.unpack_int64(2) == [tpl.nchunks, tpl.chunk]
    assert hdr.unpack_int64() == [12345]
    cs = _plan.cache_stats()
    pc = pvar.PVARS.lookup("coll_compiled_cache_hits")
    assert pc is not None, "coll/plan must register coll_compiled_cache_hits"
    st = pc.read()
    fires, hits = int(st["count"]), int(st["sum"])
    ratio = (hits / fires) if fires else 0.0
    print(f"compiled-plan cache: {hits}/{fires} hits (ratio "
          f"{ratio:.2f}; {cs['device_plans']} device plans, "
          f"{cs['spanning_plans']} spanning plans; frame template "
          f"{tpl.nchunks}x{tpl.chunk}B precomposed)")

    # 10. tuning plane: topology fingerprint round-trip, the versioned
    # tuning-db register/select cycle, dynamic-rules auto-selection
    # from the DB, and the active fingerprint + rules source printed
    # for the operator — all device-free
    from ..coll import components as _coll_components  # noqa: F401
    from ..coll import dynamic_rules as _dyn
    from ..coll.base import COLL_FRAMEWORK
    from ..tuning import db as _tdb

    COLL_FRAMEWORK.lookup("tuned").register_vars()  # the rules cvars
    fp = _tdb.active()
    assert _tdb.Fingerprint.parse(fp.canon()) == fp, fp
    with tempfile.TemporaryDirectory() as td:
        tdb = _tdb.TuningDb(td)
        p1 = tdb.register("hier_allreduce  0  0  recursive_doubling\n",
                          fp)
        p2 = tdb.register("hier_allreduce  0  0  torus2d\n", fp)
        assert p1 != p2 and tdb.best_match(fp) == p2, (p1, p2)
        fp2, v2 = _tdb.read_header(p2)
        assert fp2 == fp and v2 == 2, (fp2, v2)
        _var.set_value("coll_tuned_use_dynamic_rules", True)
        _var.set_value("coll_tuning_db_dir", td)
        try:
            assert _dyn.lookup("hier_allreduce", 8, 1 << 20) \
                == "torus2d", "db auto-selection failed"
            src = _dyn.rules_source()
            assert src["mode"] == "db" and src["path"] == p2, src
            assert src["fingerprint"] == fp.canon(), src
        finally:
            _var.VARS.unset("coll_tuned_use_dynamic_rules")
            _var.VARS.unset("coll_tuning_db_dir")
    src = _dyn.rules_source()
    print(f"tuning: fingerprint {fp.canon()}; rules source "
          f"{src['mode']}"
          + (f" ({src['path']})" if src.get("path") else "")
          + "; db register/select round-trip ok")

    # 11. plan-relative flight recorder (obs/ledger): a spanning fire
    # record encodes fixed-size, decodes losslessly, and expands
    # against its frozen plan metadata into synthetic spans whose
    # flow ids pair with the complementary rank's expansion — all
    # device-free (no plan ever fires here)
    from types import SimpleNamespace as _NS

    from . import ledger as _ledger

    _ledger._reset_for_tests()
    arrs = [((64,), "float32")]
    lp0 = _ledger.register_spanning_plan(
        7, "allreduce", 0, [_NS(sends_meta=[(1, arrs)], recvs_t=[])])
    lp1 = _ledger.register_spanning_plan(
        7, "allreduce", 1, [_NS(sends_meta=[], recvs_t=[(0, 1)])])
    seq = _ledger.record_fire(_ledger.KIND_SPANNING, lp0, 7,
                              1.0, 2.0, round0=5, round_ts=(1.5,))
    rec = _ledger.records()[-1]
    assert rec["seq"] == seq and rec["round_ts"] == [1.5], rec
    assert rec["plan"] == lp0 and rec["round0"] == 5, rec
    docs = {str(k): v for k, v in _ledger.plans().items()}
    send_spans = _ledger.expand_record(rec, docs)
    recv_spans = _ledger.expand_record(dict(rec, plan=lp1), docs)
    s_flows = [s["flow"] for s in send_spans if s.get("fs") == "s"]
    t_flows = [s["flow"] for s in recv_spans if s.get("fs") == "t"]
    assert s_flows and s_flows == t_flows, (s_flows, t_flows)
    assert any(s["op"] == "allreduce_wire_round0" for s in send_spans)
    rb = _ledger.snapshot()["record_bytes"] + 8 * len(rec["round_ts"])
    print(f"flight recorder: {rb}B/record, "
          f"{len(send_spans)} spans expanded, flow ids pair "
          f"({s_flows[0]:#x})")

    # 12. nativewire datapath (device-free): a shared-memory ring
    # moves precomposed SGH2 scatter-gather fragments bit-exactly into
    # a preallocated buffer, the SG framing joins byte-identical to
    # the staged header, and the enable switch withdraws the MCA
    # component cleanly. With the native symbols absent the leg
    # reduces to the withdrawal checks — the portable-fallback
    # contract, not a failure.
    import zlib as _zlib

    from ..btl import nativewire as _nw

    assert pvar.PVARS.lookup("wire_native_bytes") is not None
    assert pvar.PVARS.lookup("wire_native_copies_per_mib") is not None
    if _nw.nativewire_ready():
        from ..native import ShmRing as _Ring

        tpl2 = _btlc.plan_frame_template((256,), "int32", 256)
        src_arr = _np.arange(256, dtype=_np.int32)
        smv = memoryview(src_arr.view(_np.uint8))
        crc2 = _zlib.crc32(smv)
        frames2 = list(tpl2.sg_lists(smv, 11, crc2))
        assert b"".join(frames2[0]) == tpl2.header(11, crc2)
        name = f"/onw-selftest-{os.getpid():x}"
        _Ring.unlink(name)
        prod = _Ring.create(name, 1 << 16, os.getpid())
        assert prod is not None, "selftest ring create failed"
        cons = _Ring.attach(name, os.getpid())
        _Ring.unlink(name)
        assert cons is not None, "selftest ring attach failed"
        for parts in frames2[1:]:
            assert prod.writev(500, parts, 1000) == 0
        out = bytearray(tpl2.nbytes)
        for _ in range(tpl2.nchunks):
            rc = cons.read_frag(500, 11, tpl2.nchunks, tpl2.chunk,
                                out, 1000)
            assert rc >= 0, f"ring read_frag rc {rc}"
        assert bytes(out) == src_arr.tobytes(), (
            "ring fragments must land bit-exact")
        prod.close()
        cons.close()
        print(f"nativewire: ring moved {tpl2.nchunks}x{tpl2.chunk}B "
              "fragments bit-exact; SG framing joins byte-identical "
              "to the staged header")
    else:
        print("nativewire: capability absent — portable staged path "
              "in force")
    prior = os.environ.get("OMPITPU_NATIVEWIRE")
    os.environ["OMPITPU_NATIVEWIRE"] = "0"
    try:
        assert not _nw.nativewire_ready()
        assert _nw.modex_entry() == {}
        assert _nw.NativeWireComponent().query() is None
    finally:
        if prior is None:
            os.environ.pop("OMPITPU_NATIVEWIRE", None)
        else:
            os.environ["OMPITPU_NATIVEWIRE"] = prior
    print("nativewire: disable switch withdraws the component cleanly")

    # 13. frozen RMA access plans (osc/plan, device-free): epoch
    # signatures are stable metadata (identical op sequences share a
    # plan, a different target does not), the frozen wire BatchTemplate
    # renders BYTE-identical frames to the interpreted _pack_batch, and
    # a KIND_RMA ledger fire expands into an "osc"-layer span — no
    # fused program ever fires here
    from .. import ops as _ops
    from ..osc import plan as _osc_plan
    from ..osc.window import _PendingOp as _POp
    from ..osc.wire_win import _pack_batch as _pack

    def _rma_todo(tgt=1):
        return [
            _POp("put", tgt, data=_np.arange(4, dtype=_np.float32),
                 op=_ops.REPLACE),
            _POp("acc", 0, data=_np.full(4, 2.0, _np.float32),
                 op=_ops.SUM),
        ]

    rs1 = _osc_plan.epoch_signature(_rma_todo())
    rs2 = _osc_plan.epoch_signature(_rma_todo())
    rs3 = _osc_plan.epoch_signature(_rma_todo(tgt=0))
    assert rs1 == rs2 and rs1 != rs3, (rs1, rs3)
    todo = _rma_todo()
    tpl3 = _osc_plan.BatchTemplate(_var.VARS.generation, todo)
    assert tpl3.render(todo).tobytes() == _pack(todo).tobytes(), (
        "frozen frame template must render byte-identical to "
        "_pack_batch")
    rlid = _ledger.register_rma_plan(9, "epoch[2]", 32, rs1)
    _ledger.record_fire(_ledger.KIND_RMA, rlid, 9, 3.0, 3.5)
    rrec = _ledger.records()[-1]
    rdocs = {str(k): v for k, v in _ledger.plans().items()}
    rspans = _ledger.expand_record(rrec, rdocs)
    assert rspans and all(s["layer"] == "osc" for s in rspans), rspans
    rcs = _osc_plan.cache_stats()
    print(f"rma plans: signatures stable; frames byte-identical; "
          f"KIND_RMA expands to osc-layer spans; "
          f"{rcs['epoch_plans']} plans / {rcs['programs']} programs / "
          f"{rcs['fires']} fires")

    # 14. native wire telemetry (device-free): the always-on counters
    # block in the shm ring header observes a writev/read_frag
    # round-trip (frames, bytes, occupancy high-water, a timed-out
    # empty read as one stall), and the optional event ring records one
    # 32-byte record per side whose expansion pairs flow ids across
    # send and recv — the doctor's cross-process arrows, demonstrated
    # inside one process. Symbols absent = the leg reduces to the
    # pvar-presence checks (portable fallback, not a failure).
    from ..native import telemetry_symbols_available as _tele_ok
    from . import nativeev as _nativeev

    for nm in ("wire_native_ring_stalls", "wire_native_stall_seconds",
               "wire_native_ring_hwm_frac"):
        assert pvar.PVARS.lookup(nm) is not None, nm
    if _nw.nativewire_ready() and _tele_ok():
        from ..native import NativeEventRing as _EvRing
        from ..native import ShmRing as _Ring2

        evname = f"/onwev-selftest-{os.getpid():x}"
        _EvRing.unlink(evname)
        ev = _EvRing.create(evname, 256)
        assert ev is not None, "selftest event ring create failed"
        _EvRing.unlink(evname)
        ev.install()
        try:
            tpl4 = _btlc.plan_frame_template((64,), "int32", 1 << 10)
            arr4 = _np.arange(64, dtype=_np.int32)
            mv4 = memoryview(arr4.view(_np.uint8))
            frames4 = list(tpl4.sg_lists(mv4, 21, _zlib.crc32(mv4)))
            name = f"/onwt-selftest-{os.getpid():x}"
            _Ring2.unlink(name)
            prod = _Ring2.create(name, 1 << 16, os.getpid())
            cons = _Ring2.attach(name, os.getpid())
            _Ring2.unlink(name)
            assert prod is not None and cons is not None
            s0 = prod.stats()
            assert prod.writev(501, frames4[1], 1000) == 0
            out4 = bytearray(tpl4.nbytes)
            rc = cons.read_frag(501, 21, tpl4.nchunks, tpl4.chunk,
                                out4, 1000)
            assert rc >= 0, f"telemetry leg read_frag rc {rc}"
            s1 = cons.stats()
            assert s1["w_frames"] == s0["w_frames"] + 1, (s0, s1)
            assert s1["w_bytes"] > s0["w_bytes"], (s0, s1)
            assert s1["r_frames"] == s0["r_frames"] + 1, (s0, s1)
            assert s1["r_bytes"] == s1["w_bytes"], s1
            assert s1["hwm"] > 0, s1
            # a timed-out empty read is ONE stall with measured time
            rc = cons.read_frag(501, 21, tpl4.nchunks, tpl4.chunk,
                                out4, 30)
            assert rc == -1, rc
            s2 = cons.stats()
            assert s2["r_stalls"] == s1["r_stalls"] + 1, (s1, s2)
            assert s2["r_stall_ns"] > s1["r_stall_ns"], (s1, s2)
            # the event ring saw both sides of the fragment
            assert ev.count() >= 2, ev.count()
            doc = _nativeev.snapshot(ev)
            assert doc["format"] == _nativeev.FORMAT
            recs = doc["records"]
            assert any(r["recv"] for r in recs), recs
            assert any(not r["recv"] for r in recs), recs
            r0 = recs[0]
            assert r0["tag"] == 501 and r0["xfer"] == 21, r0
            assert r0["bytes"] == len(frames4[1][-1]), r0
            spans4 = _nativeev.expand_dump(doc)
            assert all(s["layer"] == "wire" for s in spans4), spans4
            sflow = {s["flow"] for s in spans4 if s["fs"] == "s"}
            tflow = {s["flow"] for s in spans4 if s["fs"] == "t"}
            assert sflow and sflow == tflow, (sflow, tflow)
            assert sflow == {_nativeev.frag_flow_id(501, 21, 0)}
            prod.close()
            cons.close()
            print(f"native telemetry: counters observed "
                  f"{s1['w_frames'] - s0['w_frames']} frame / "
                  f"{s1['w_bytes'] - s0['w_bytes']}B, stall "
                  f"{(s2['r_stall_ns'] - s1['r_stall_ns']) / 1e6:.1f} "
                  f"ms; {len(recs)} event records expand to paired "
                  f"wire spans ({next(iter(sflow)):#x})")
        finally:
            ev.uninstall()
            ev.close()
    else:
        print("native telemetry: symbols absent — counters fold to "
              "zero, event ring stays off")

    # 15. native plan executor (device-free): a frozen two-round wire
    # plan compiles into the flat descriptor table the C executor
    # walks (build_blob -> planexec_create introspection, no wire, no
    # peers), and a spanning-plan ledger fire carrying C-stamped round
    # boundaries round-trips: the timestamps come back through the
    # binary ring record exactly as the executor wrote them. Symbols
    # absent = the compile leg reduces to the graceful-withdrawal
    # check (try_compile returns None, never raises).
    from ..coll import native_exec as _nx
    from ..coll import plan as _cplan

    for nm in ("plan_pool_bytes", "plan_pool_hits",
               "plan_native_fires", "plan_native_fallbacks"):
        assert pvar.PVARS.lookup(nm) is not None, nm
    if _nx.available():
        from ..native.bindings import PlanExec as _PlanExec

        blob = _nx.build_blob(
            600, [256], [128, 256], [1, 2],
            [{"depth": 2,
              "streams": [(0, [(b"P0", b"M0", 256, 0, 256,
                                ((0, 0, 0, 256),))])],
              "rsrcs": [(1, [(0, 128, 0, 128, b"P1", b"M1")])]},
             {"depth": 2,
              "streams": [(1, [(b"P2", b"M2", 128, 0, 128,
                                ((1, 0, 0, 128),))])],
              "rsrcs": [(0, [(1, 256, 0, 256, b"P3", b"M3")])]}])
        pxn = _PlanExec(blob)
        try:
            assert pxn.round_count == 2 and pxn.input_count == 1
            assert pxn.pool_count == 2 and pxn.pool_total == 384
        finally:
            pxn.close()
        print("native plan executor: 2-round descriptor table "
              f"({len(blob)}B) compiled and introspected device-free")
    else:
        assert _nx.try_compile(
            type("S", (), {"plan": None})(), object(), None, (), {}) \
            is None
        print("native plan executor: symbols absent — try_compile "
              "withdraws, interpreted replay in force")
    rnd_n = _cplan.WireRound(((1, (((64,), "int32"),)),), ((1, 1),),
                             ((1, (None,)),), 600, 2)
    lpn = _ledger.register_spanning_plan(62, "native_selftest", 0,
                                         [rnd_n, rnd_n])
    tsn = (time.perf_counter(), time.perf_counter() + 1e-4)
    seqn = _ledger.record_fire(_ledger.KIND_SPANNING, lpn, 62,
                               tsn[0] - 1e-4, tsn[1], round0=4,
                               round_ts=tsn)
    recn = [r for r in _ledger.records() if r["seq"] == seqn][0]
    assert recn["plan"] == lpn and recn["round0"] == 4
    assert tuple(recn["round_ts"]) == tsn, recn
    spans_n = _ledger.expand_record(recn, _ledger.plans())
    assert any(s["op"].endswith("wire_round1") for s in spans_n), \
        spans_n
    print("native plan executor: C-stamped round boundaries "
          f"round-trip the ledger ({len(spans_n)} spans)")

    disable()
    print("obs selftest: ok")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "doctor":
        # `python -m ompi_release_tpu_torch.obs doctor ...` == tpu-doctor
        from ..tools.tpu_doctor import main as doctor_main

        return doctor_main(argv[1:])
    ap = argparse.ArgumentParser(
        prog="python -m ompi_release_tpu_torch.obs",
        description="Observability-plane utilities ('doctor ...' "
                    "forwards to tpu-doctor: merge/report/postmortem/"
                    "contracts)")
    ap.add_argument("--selftest", action="store_true",
                    help="register/bump/export/verify every pvar class "
                         "and exporter (device-free)")
    args = ap.parse_args(argv)
    if args.selftest:
        return selftest()
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
