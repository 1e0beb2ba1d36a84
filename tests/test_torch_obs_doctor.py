"""The port's doctor, flight recorder and native event ring held against
the JAX package's.

A three-process dump directory (journals with coll rounds, hier and wire
flows, sentinel signatures and ft incidents; sampler series; ledger
fire records; native event records) is written once through each
package's own writers from the same inputs: the files are byte for byte
the same, and each package's doctor gives the same ``merge``,
``flow_pairs``, ``skew_report`` (with the series), ``contract_report``,
``incident_timeline`` and ``merge_series`` on either directory. The
ledger's fixed-size records, their decoding and their expansion are
bitwise the JAX package's for the same fire sequence; a native event
ring filled by the C transports decodes the same through both
packages' bindings and expands to the same spans.
"""

import importlib
import json
import os
from types import SimpleNamespace as NS

import numpy as np
import pytest

from ompi_release_tpu import obs as jobs
from ompi_release_tpu.obs import doctor as jdoctor
from ompi_release_tpu.obs import export as jexport
from ompi_release_tpu.obs import ledger as jledger
from ompi_release_tpu.obs import nativeev as jnativeev
from ompi_release_tpu_torch import obs as tobs
from ompi_release_tpu_torch.obs import doctor as tdoctor
from ompi_release_tpu_torch.obs import export as texport
from ompi_release_tpu_torch.obs import ledger as tledger
from ompi_release_tpu_torch.obs import nativeev as tnativeev

PKGS = {"jax": (jobs, jexport, jledger, jnativeev, "ompi_release_tpu"),
        "torch": (tobs, texport, tledger, tnativeev,
                  "ompi_release_tpu_torch")}
PROCS = 3


class _FakeRing:
    """The two calls a dump makes of a native event ring."""

    def __init__(self, recs):
        self.recs = recs

    def read(self):
        return 0, list(self.recs)

    def count(self):
        return len(self.recs)


def _native_recs(p, rs):
    out = []
    for k in range(6):
        src = (p - 1) % PROCS
        out.append({"t_ns": int(1e12 + 1e6 * k + p), "xfer": k,
                    "tag": 900 + p, "bytes": 4096, "idx": k % 3,
                    "recv": False, "wait_ns": int(rs.randint(0, 1000))})
        out.append({"t_ns": int(1e12 + 1e6 * k + 500 + p), "xfer": k,
                    "tag": 900 + src, "bytes": 4096, "idx": k % 3,
                    "recv": True, "wait_ns": int(rs.randint(0, 1000))})
    return out


def _write_dir(pkg, d, monkeypatch):
    """Every dump kind of a 3-process job, written by ``pkg``'s own
    writers from the same inputs."""
    o, export, ledger, nativeev, _name = PKGS[pkg]
    journal = importlib.import_module(o.__name__ + ".journal")
    o.disable()  # no sentinel chains in the dumps' meta
    rs = np.random.RandomState(7)
    for p in range(PROCS):
        ident = {"pid": 1000 + p, "pidx": p, "rank_offset": 2 * p,
                 "local_size": 2}
        monkeypatch.setattr(o, "rank_identity", lambda i=ident: dict(i))
        o.set_clock(0.01 * p, 0.0005, "oob")
        # a fresh journal a process: span seqs count from 0 whatever
        # earlier tests recorded
        fresh = journal.Journal()
        monkeypatch.setattr(o, "journal", fresh)
        monkeypatch.setattr(export, "_JOURNAL", fresh)
        t = 100.0
        for r in range(4):  # rounds: proc 1 is late in round 2
            late = 0.5 if (r == 2 and p == 1) else 0.001 * p
            o.record("allreduce", "coll", t + late, 0.01, nbytes=1024,
                     comm_id=0)
            for k, q in enumerate(x for x in range(PROCS) if x != p):
                o.record("hier_send", "hier", t + late, 0.0, nbytes=256,
                         peer=q, comm_id=0,
                         flow=journal.flow_id("hier", 0, r + 1, p, q, 0),
                         flow_side="s")
                o.record("hier_recv", "hier", t + 0.6, 0.001,
                         nbytes=256, peer=q, comm_id=0,
                         flow=journal.flow_id("hier", 0, r + 1, q, p, 0),
                         flow_side="t")
            canon = "allreduce|sum|float32|256|-1"
            o.record(f"{canon}|e0|app.py:{10 + r}", "sentinel", t, 0.0,
                     nbytes=256, peer=r, comm_id=0,
                     flow=journal.flow_id(r, canon), flow_side="g")
            t += 1.0
        o.record("wire_send", "wire", t, 0.002, nbytes=64,
                 peer=(p + 1) % PROCS, comm_id=0,
                 flow=journal.flow_id("p2p", p, 1), flow_side="s")
        o.record("wire_recv", "wire", t + 0.01, 0.002, nbytes=64,
                 peer=(p - 1) % PROCS, comm_id=0,
                 flow=journal.flow_id("p2p", (p - 1) % PROCS, 1),
                 flow_side="t")
        if p == 0:
            o.record("ft_failure", "ft", t + 1, 0.0, peer=2, comm_id=1)
            o.record("ft_revoke", "ft", t + 1.1, 0.0, peer=1, comm_id=0)
            o.record("ft_recovery", "ft", t + 1.2, 0.8, peer=4,
                     comm_id=524288)
        export.dump_rank_journal(os.path.join(d, f"journal-p{p}.json"),
                                 clock_sync=False)
        pts = [{"i": i, "t": 100.0 + 0.1 * i, "cid": (-1, 0)[i % 2],
                "name": ("x_counter", "coll_ops", "coll_bytes",
                         "coll_seconds")[i % 4],
                "v": float(rs.randint(1, 9))} for i in range(24)]
        export.dump_series_jsonl(
            os.path.join(d, f"series-p{p}.jsonl"),
            {"meta": dict(ident, clock_offset_s=0.01 * p,
                          clock_rtt_s=0.0005), "points": pts})
        ledger._reset_for_tests()
        sends = [(q, [((64,), "float32")]) for q in range(PROCS) if q != p]
        recvs = [(q, 1) for q in range(PROCS) if q != p]
        lid = ledger.register_spanning_plan(
            0, "allreduce", p, [NS(sends_meta=sends, recvs_t=recvs)])
        did = ledger.register_device_plan(-1, "allreduce", 2048)
        for k in range(3):
            ledger.record_fire(ledger.KIND_SPANNING, lid, 0, t + k,
                               t + k + 0.01, round0=5 + k,
                               round_ts=(t + k + 0.01,))
            ledger.record_fire(ledger.KIND_DEVICE, did, -1, t + k,
                               t + k + 0.002)
        ledger.dump(os.path.join(d, f"ledger-p{p}.json"))
        ev = nativeev.snapshot(_FakeRing(_native_recs(p, rs)))
        ev["rt_minus_pc"] = 1000.0  # the dump-time bridge, fixed here
        with open(os.path.join(d, f"nativeev-p{p}.json"), "w") as f:
            json.dump(ev, f)
    ledger._reset_for_tests()
    o._clock_state.update(offset_s=None, rtt_s=None, source=None)


@pytest.fixture()
def dump_dirs(tmp_path, monkeypatch):
    out = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir()
        _write_dir(pkg, str(d), monkeypatch)
        out[pkg] = str(d)
    return out


def test_dump_files_byte_identical(dump_dirs):
    names = sorted(os.listdir(dump_dirs["jax"]))
    assert names == sorted(os.listdir(dump_dirs["torch"]))
    assert len(names) == 4 * PROCS
    for n in names:
        with open(os.path.join(dump_dirs["jax"], n), "rb") as a, \
                open(os.path.join(dump_dirs["torch"], n), "rb") as b:
            assert a.read() == b.read(), n


def _report(doctor, d):
    dumps = doctor.load_dir(d)
    series = doctor.load_series_dir(d)
    return {"merge": doctor.merge(dumps),
            "pairs": doctor.flow_pairs(dumps),
            "skew": doctor.skew_report(dumps, series=series),
            "contracts": doctor.contract_report(dumps, directory=d),
            "incidents": doctor.incident_timeline(dumps),
            "series": doctor.merge_series(series)}


@pytest.mark.parametrize("writer", sorted(PKGS))
def test_doctors_agree_on_either_packages_dumps(dump_dirs, writer):
    d = dump_dirs[writer]
    want = _report(jdoctor, d)
    got = _report(tdoctor, d)
    for key in want:
        assert got[key] == want[key], key
    od = got["merge"]["otherData"]
    assert od["processes"] == PROCS and od["cross_process_flows"] > 0
    late = max((r for r in got["skew"][1]["rounds"]
                if r["op"] == "allreduce"), key=lambda r: r["spread_s"])
    assert late["slowest_pidx"] == 1
    assert got["contracts"][1]["divergences"] == 0
    assert [e["op"] for e in got["incidents"]] == [
        "ft_failure", "ft_revoke", "ft_recovery"]
    native = [p for p in got["pairs"] if p["src"].get("nativeev")]
    ledger_spans = [p for p in got["pairs"] if p["src"].get("ledger")]
    assert native and ledger_spans


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_cli_merge_report_contracts(dump_dirs, pkg, capsys):
    """``tpu_doctor merge|report|contracts DIR`` of the port on a
    directory either package wrote prints what the JAX CLI prints."""
    from ompi_release_tpu.tools import tpu_doctor as jcli
    from ompi_release_tpu_torch.tools import tpu_doctor as tcli

    d = dump_dirs[pkg]
    for argv in (["report", d], ["contracts", d]):
        rc_j = jcli.main(argv)
        out_j = capsys.readouterr().out
        rc_t = tcli.main(argv)
        out_t = capsys.readouterr().out
        assert (rc_t, out_t) == (rc_j, out_j), argv
    out = os.path.join(d, "..", f"{pkg}-trace.json")
    assert tcli.main(["merge", d, "-o", out]) == 0
    assert "cross-process" in capsys.readouterr().out
    with open(out) as f:
        assert json.load(f) == jdoctor.merge(jdoctor.load_dir(d))


# ---------------------------------------------------------------------------
# the flight recorder: records, decoding and expansion, bitwise
# ---------------------------------------------------------------------------

def _fires(ledger, dtype):
    ledger._reset_for_tests()
    a = ledger.register_spanning_plan(
        7, "allreduce", 0,
        [NS(sends_meta=[(1, [((64,), dtype), ((3, 5), dtype)])],
            recvs_t=[(1, 2)]),
         NS(sends_meta=[], recvs_t=[(2, 1)])], sig=("allreduce", 1))
    b = ledger.register_device_plan(3, "bcast", 4096, sig=("bcast",))
    c = ledger.register_rma_plan(9, "epoch[2]", 32)
    seqs = [ledger.record_fire(ledger.KIND_SPANNING, a, 7, 1.0, 2.0,
                               round0=5, round_ts=(1.25, 1.75)),
            ledger.record_fire(ledger.KIND_DEVICE, b, 3, 2.5, 2.75),
            ledger.record_fire(ledger.KIND_RMA, c, 9, 3.0, 3.5,
                               round0=2 ** 33)]
    raw = [r for r in ledger._ring if r is not None]
    recs = ledger.records()
    plans = {str(k): v for k, v in ledger.plans().items()}
    spans = [ledger.expand_record(r, plans, 0) for r in recs]
    ledger._reset_for_tests()
    return seqs, raw, recs, plans, spans


def test_ledger_records_bitwise():
    import torch

    want = _fires(jledger, "float32")
    assert _fires(tledger, "float32") == want
    # the port's wire plans may carry torch dtypes: the same sizes
    assert _fires(tledger, torch.float32) == want
    seqs, raw, recs, plans, spans = want
    assert [len(r) for r in raw] == [39 + 16, 39, 39]
    assert plans["1"]["rounds"][0]["sends"] == [[1, [256, 60]]]
    assert [s["op"] for s in spans[0]].count("hier_send") == 2


def test_ledger_wrap_and_dump_roundtrip(tmp_path):
    for led in (jledger, tledger):
        led._reset_for_tests()
        led.resize(4)
        pid = led.register_device_plan(1, "gather", 64)
        for k in range(6):
            led.record_fire(led.KIND_DEVICE, pid, 1, float(k), k + 0.5)
    assert tledger.records() == jledger.records()
    assert [r["seq"] for r in tledger.records()] == [2, 3, 4, 5]
    path = tledger.dump(str(tmp_path / "ledger-p0.json"))
    assert tdoctor.load_ledger_dump(path) == jdoctor.load_ledger_dump(path)
    for led in (jledger, tledger):
        led._reset_for_tests()


# ---------------------------------------------------------------------------
# the native event ring: the C records through both bindings
# ---------------------------------------------------------------------------

def test_native_event_ring_decodes_the_same():
    import zlib

    from ompi_release_tpu.native import bindings as jb
    from ompi_release_tpu_torch.btl import components as btlc
    from ompi_release_tpu_torch.native import bindings as tb

    if not (tb.telemetry_symbols_available()
            and jb.telemetry_symbols_available()):
        pytest.fail("the native telemetry symbols are missing")
    name = f"/onwev-obsparity-{os.getpid():x}"
    tb.NativeEventRing.unlink(name)
    ev = tb.NativeEventRing.create(name, 256)
    assert ev is not None
    jev = jb.NativeEventRing.attach(name)
    tb.NativeEventRing.unlink(name)
    assert jev is not None
    ev.install()
    try:
        tpl = btlc.plan_frame_template((64,), "int32", 1 << 10)
        arr = np.arange(64, dtype=np.int32)
        mv = memoryview(arr.view(np.uint8))
        frames = list(tpl.sg_lists(mv, 21, zlib.crc32(mv)))
        rname = f"/onwt-obsparity-{os.getpid():x}"
        tb.ShmRing.unlink(rname)
        prod = tb.ShmRing.create(rname, 1 << 16, os.getpid())
        cons = tb.ShmRing.attach(rname, os.getpid())
        tb.ShmRing.unlink(rname)
        assert prod.writev(501, frames[1], 1000) == 0
        out = bytearray(tpl.nbytes)
        assert cons.read_frag(501, 21, tpl.nchunks, tpl.chunk, out,
                              1000) >= 0
        prod.close()
        cons.close()
    finally:
        ev.uninstall()
    got, want = ev.read(), jev.read()
    assert got == want and ev.count() == jev.count() == 2
    assert {r["recv"] for r in got[1]} == {False, True}
    doc = tnativeev.snapshot(ev)
    assert tnativeev.expand_dump(doc) == jnativeev.expand_dump(doc)
    flows = {s["flow"] for s in tnativeev.expand_dump(doc)}
    assert flows == {jnativeev.frag_flow_id(501, 21, 0)}
    ev.close()
    jev.close()
