"""The port's collective contract sentinel (``obs/sentinel.py``) held
against the JAX package's: the same call streams through the entry
points (blocking, i-family, persistent) fold to bitwise the same chain
values and 16-byte digests in f32, bf16 and int32 (the canon carries
numpy's dtype names, the leading rank axis stripped); the doctors'
``contract_report`` agrees on the JAX tests' synthetic desyncs
(``tests/test_sentinel.py:174-325``); the inline frame template renders
byte-identical payloads; a chain goes when its comm is freed or
revoked.
"""

import importlib
import json

import ml_dtypes
import numpy as np
import pytest

import ompi_release_tpu as jmpi
from ompi_release_tpu import obs as jobs
from ompi_release_tpu import ops as jops
from ompi_release_tpu.mca import var as jvar
from ompi_release_tpu.obs import doctor as jdoctor
from ompi_release_tpu.obs import sentinel as jsent
import ompi_release_tpu_torch as tmpi
from ompi_release_tpu_torch import obs as tobs
from ompi_release_tpu_torch import ops as tops
from ompi_release_tpu_torch.mca import var as tvar
from ompi_release_tpu_torch.obs import doctor as tdoctor
from ompi_release_tpu_torch.obs import sentinel as tsent
from ompi_release_tpu_torch.runtime import runtime as trt

N = 8
SIDES = {"jax": (jobs, jvar, jsent, jops), "torch": (tobs, tvar, tsent, tops)}
DTYPES = {"f32": np.float32, "bf16": ml_dtypes.bfloat16, "i32": np.int32}


@pytest.fixture(scope="module")
def comms():
    jworld = jmpi.init()
    trt._reset_for_tests()
    tworld = tmpi.init(cli_args=["--mca", "runtime_virtual_ranks", str(N)],
                       device="cpu")
    jvar.set_value("coll", "tuned")
    tvar.set_value("coll", "tuned")
    try:
        out = {"jax": jworld.dup(name="sent_tuned"),
               "torch": tworld.dup(name="sent_tuned")}
    finally:
        jvar.VARS.unset("coll")
        tvar.VARS.unset("coll")
    yield out
    for c in out.values():
        c.free()
    trt._reset_for_tests()
    tvar.VARS.unset("runtime_virtual_ranks")


@pytest.fixture()
def armed():
    """obs + sentinel post-hoc mode on in both packages, the journals
    empty (earlier tests in the process may have left spans of a comm
    whose cid is reused), restored."""
    for o, var, sent, _ in SIDES.values():
        sent._reset_for_tests()
        o.journal.clear()
        var.set_value("obs_sentinel", 1)
        o.enable()
        sent.refresh(True)
    yield
    for o, var, sent, _ in SIDES.values():
        var.VARS.unset("obs_sentinel")
        sent._reset_for_tests()
        o.disable()
        o.journal.clear()


def _stream(c, ops, dt):
    """One call stream through every entry point (one call site per
    call, shared by both packages)."""
    x = (np.arange(N * 24).reshape(N, 24) % 7).astype(dt)
    c.allreduce(x)
    c.bcast(x, root=2)
    c.reduce(x, ops.MAX, root=1)
    c.allgather(x[:, :4])
    c.iallreduce(x).wait()
    req = c.allreduce_init(x)
    req.start()
    req.wait()
    req.start()
    req.wait()
    c.barrier()


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_entry_point_chains_bitwise(comms, armed, dt):
    got = {}
    for pkg, (o, _var, sent, ops) in SIDES.items():
        c = comms[pkg]
        _stream(c, ops, DTYPES[dt])
        spans = [(s.op, s.peer, s.nbytes, s.flow)
                 for s in o.journal.snapshot()
                 if s.layer == "sentinel" and s.comm_id == c.cid]
        snap = sent.chains_snapshot()["comms"][str(c.cid)]
        got[pkg] = (spans, snap["next_seq"], snap["chain"],
                    [dict(d, site=None) for d in snap["last"]])
    assert got["torch"] == got["jax"]
    spans = got["torch"][0]
    assert len(spans) == 8 and got["torch"][1] == 8
    canon = tsent.parse_op(spans[0][0])["canon"]
    name = {"f32": "float32", "bf16": "bfloat16", "i32": "int32"}[dt]
    assert canon == f"allreduce|sum|{name}|24|-1", canon


@pytest.mark.parametrize("dt", ["float32", "bfloat16", "int32"])
def test_record_sig_digests_bitwise(armed, dt):
    sigs = {}
    for pkg, (_o, _var, sent, _ops) in SIDES.items():
        out = []
        for fam, op, cnt, root in (("allreduce", "sum", 1024, -1),
                                   ("bcast", "-", 1024, 0),
                                   ("reduce", "max", 64, 2),
                                   ("scan", "prod", 7, -1)):
            s = sent.record_sig(41, fam, op, dt, cnt, root, epoch=3,
                                site="app.py:12")
            out.append((s.digest(), s.chain, s.descriptor()))
        sigs[pkg] = out
    assert sigs["torch"] == sigs["jax"]


def test_canon_dtype_names():
    import torch

    for t, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16"),
                    (torch.int32, "int32"), (torch.float16, "float16"),
                    (np.dtype(np.int64), "int64")):
        assert tsent.dtype_name(t) == name


def test_inline_frame_template_byte_identical():
    canon = tsent.make_canon("allreduce", "sum", "float32", 512, -1)
    assert canon == jsent.make_canon("allreduce", "sum", "float32", 512, -1)
    site = "app.py:42"
    for seq, epoch, prev in ((0, 0, 0), (7, 2, 12345), (2 ** 31, 9, 2 ** 60)):
        ts = tsent.CallSig(3, seq, "allreduce", canon, epoch, site, prev)
        js = jsent.CallSig(3, seq, "allreduce", canon, epoch, site, prev)
        want = js.digest() + json.dumps(js.descriptor()).encode()
        assert tsent.InlineFrameTemplate(canon, site).render(ts) == want
        assert jsent.InlineFrameTemplate(canon, site).render(js) == want


def test_chain_cleared_on_free_and_revoke(comms, armed):
    tworld = trt.Runtime.current().world
    x = np.ones((N, 4), np.float32)
    sub = tworld.dup(name="sent_free")
    sub.allreduce(x)
    assert tsent.chain_of(sub.cid) != 0
    sub.free()
    assert tsent.chain_of(sub.cid) == 0
    sub = tworld.dup(name="sent_revoke")
    sub.allreduce(x)
    cid = sub.cid
    assert tsent.chain_of(cid) != 0
    sub.revoke()
    assert tsent.chain_of(cid) == 0
    sub.free()


def test_internal_comms_are_not_noted(comms, armed):
    """Runtime-private comms (negative cids, like the hier shadow) are
    never noted: their cids are not agreed across processes."""
    from ompi_release_tpu_torch.comm.communicator import Communicator

    internal = Communicator(trt.Runtime.current(), comms["torch"].group,
                            name="sent_internal", internal=True)
    assert internal.cid < 0
    assert tsent.note(internal, "allreduce", (np.ones((N, 2)),)) is None
    assert str(internal.cid) not in tsent.chains_snapshot()["comms"]
    internal.free()


# ---------------------------------------------------------------------------
# the doctors' contract alignment on the JAX tests' synthetic desyncs
# ---------------------------------------------------------------------------

def _sig_span(cid, seq, canon, site, epoch=0):
    op = jsent.encode_op(canon, epoch, site)
    assert op == tsent.encode_op(canon, epoch, site)
    return {"seq": seq, "op": op, "layer": "sentinel", "t": 1.0 + seq,
            "dt": 0.0, "bytes": 0, "peer": seq, "comm": cid}


def _dump(pidx, spans):
    return {"meta": {"pidx": pidx, "rank_offset": pidx, "local_size": 1,
                     "clock_offset_s": 0.0},
            "spans": spans}


AR = "allreduce|sum|float32|64|-1"
BC = "bcast|-|float32|64|0"
BAR = "barrier|-|-|0|-1"


def _meta_dump(pidx, canon, site):
    d = _dump(pidx, [])
    d["meta"]["sentinel"] = {"mode": 1, "comms": {"0": {
        "next_seq": 1, "chain": "ab",
        "last": [{"seq": 0, "canon": canon, "epoch": 0,
                  "site": site, "sig": 1}]}}}
    return d


CASES = {
    "aligned": [_dump(p, [_sig_span(0, s, c, f"dp.py:{10 + s}")
                          for s, c in enumerate((AR, BAR, AR))])
                for p in range(3)],
    "mismatch": [
        _dump(0, [_sig_span(0, 0, AR, "dp.py:203"),
                  _sig_span(0, 1, AR, "dp.py:203")]),
        _dump(1, [_sig_span(0, 0, AR, "dp.py:203"),
                  _sig_span(0, 1, AR, "dp.py:203")]),
        _dump(2, [_sig_span(0, 0, AR, "dp.py:203"),
                  _sig_span(0, 1, BC, "train.py:88")])],
    "majority": [_dump(0, [_sig_span(0, 0, BC, "train.py:88")]),
                 _dump(1, [_sig_span(0, 0, AR, "dp.py:203")]),
                 _dump(2, [_sig_span(0, 0, AR, "dp.py:203")])],
    "swap": [
        _dump(0, [_sig_span(0, 0, AR, "a.py:1"),
                  _sig_span(0, 1, BAR, "a.py:2"),
                  _sig_span(0, 2, AR, "a.py:3")]),
        _dump(1, [_sig_span(0, 0, AR, "a.py:1"),
                  _sig_span(0, 2, BAR, "b.py:9"),
                  _sig_span(0, 1, AR, "b.py:8")])],
    "missing": [_dump(p, [_sig_span(0, s, AR, "a.py:1")
                          for s in range(4 if p < 2 else 2)])
                for p in range(3)],
    "ring_wrap": [
        _dump(0, [_sig_span(0, s, AR, "a.py:1") for s in range(6)]),
        _dump(1, [_sig_span(0, s, AR, "a.py:1") for s in range(3, 6)])],
    "epoch_skew": [_dump(0, [_sig_span(0, 0, AR, "a.py:1", epoch=2)]),
                   _dump(1, [_sig_span(0, 0, AR, "a.py:1", epoch=1)])],
    "transient_epoch": [
        _dump(0, [_sig_span(0, 0, AR, "a.py:1", epoch=1),
                  _sig_span(0, 1, AR, "a.py:1", epoch=1)]),
        _dump(1, [_sig_span(0, 0, AR, "a.py:1", epoch=0),
                  _sig_span(0, 1, AR, "a.py:1", epoch=1)])],
    "fresh_expected": [_dump(0, [_sig_span(0, 0, AR, "a.py:1", epoch=1)]),
                       _dump(1, [_sig_span(0, 0, AR, "b.py:2", epoch=2)])],
    "meta_ring": [_meta_dump(0, AR, "dp.py:203"),
                  _meta_dump(1, BC, "train.py:88")],
}
KINDS = {"aligned": None, "mismatch": "signature_mismatch",
         "majority": "signature_mismatch", "swap": "posting_order_swap",
         "missing": "missing_participant", "ring_wrap": None,
         "epoch_skew": "epoch_skew", "transient_epoch": None,
         "fresh_expected": "epoch_skew", "meta_ring": "signature_mismatch"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_contract_report_matches_jax(case):
    dumps = json.loads(json.dumps(CASES[case]))
    want = jdoctor.contract_report(json.loads(json.dumps(dumps)))
    got = tdoctor.contract_report(dumps)
    assert got == want
    div = (got[1]["comms"].get("0") or {}).get("divergence")
    assert (div or {}).get("kind") == KINDS[case], (case, got[0])


def test_contract_report_on_postmortems(tmp_path):
    for p, canon, site in ((0, AR, "dp.py:203"), (1, BC, "train.py:88")):
        pm = {"reason": "stall", "time_unix": 1.0,
              "rank": {"pidx": p, "pid": 100 + p, "rank_offset": p,
                       "local_size": 1},
              "clock": {"offset_s": 0.0}, "journal_tail": [],
              "sentinel": {"mode": 1, "comms": {"0": {
                  "next_seq": 1, "chain": "ab",
                  "last": [{"seq": 0, "canon": canon, "epoch": 0,
                            "site": site, "sig": 1}]}}}}
        (tmp_path / f"postmortem-p{p}-stall-1.json").write_text(
            json.dumps(pm))
    got = tdoctor.contract_report(tdoctor.load_dir(str(tmp_path)),
                                  directory=str(tmp_path))
    want = jdoctor.contract_report(jdoctor.load_dir(str(tmp_path)),
                                   directory=str(tmp_path))
    assert got == want and got[1]["divergences"] == 1
    assert "train.py:88" in got[0] and "dp.py:203" in got[0]


def test_parse_op_and_sentinel_pvars(armed):
    tsent.record_sig(5, "allgather", "-", "bfloat16", 16, -1,
                     site="x.py:1")
    op = tobs.journal.snapshot()[-1].op
    assert tsent.parse_op(op) == jsent.parse_op(op)
    pv = importlib.import_module("ompi_release_tpu_torch.mca.pvar")
    assert float(pv.PVARS.lookup("sentinel_ops_hashed").read()) >= 1
