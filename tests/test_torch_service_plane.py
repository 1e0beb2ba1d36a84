"""The port's service plane held against the JAX package's.

- The cid band: the shared counter stops at ``TENANT_CID_BASE`` and
  never yields a tenant-band cid; the tenant band math (``tenant_band``,
  ``tenant_cid``, ``tenant_of_cid``, a tenant's ``ft_cid``) equals the
  JAX package's over whole ranges.
- ``service/qos.py``: ``parse_classes``, ``fair_share`` and
  ``lane_ranges`` over a grid of specs and lane counts, typed errors
  included; ``WireArbiter`` on one scripted enter/gate/leave sequence
  (a fake condition and clock make it single-threaded): the same parks
  and the same spends.
- ``service/tenant.py``: one admit/renew/expire/evict script gives the
  same documents (tokens and times masked).
- ``runtime/wire.py``: the lane classes through the tuning snapshot, the
  striper's arbiter and frame counts; ``coll/native_exec`` withdraws
  while ``wire_qos_classes`` is set.
- ``service/daemon.py``: a port client against a JAX daemon and a JAX
  client against the port's give the same tenant documents, and both
  packages' ``tpu_top --tenants`` render them alike.
- Real comms: a band revoke poisons only that tenant's comm; the QoS
  stamp is inherited.
- The JAX package's two-jobs kill-isolation episode
  (``tests/test_service_plane.py``) through the port's ``tpurun`` on the
  CPU.
"""

import itertools
import os
import signal
import sys
import textwrap
import threading
import time
from types import SimpleNamespace as NS

import numpy as np
import pytest

from ompi_release_tpu.ft import ulfm as julfm
from ompi_release_tpu.service import daemon as jdaemon
from ompi_release_tpu.service import qos as jqos
from ompi_release_tpu.service import tenant as jtenant
from ompi_release_tpu.tools import tpu_top as jtop
from ompi_release_tpu.utils.errors import MPIError as JMPIError

import ompi_release_tpu_torch as tmpi
from ompi_release_tpu_torch.comm import communicator as tcomm_mod
from ompi_release_tpu_torch.ft import ulfm as tulfm
from ompi_release_tpu_torch.mca import pvar as tpvar
from ompi_release_tpu_torch.mca import var as tvar
from ompi_release_tpu_torch.service import daemon as tdaemon
from ompi_release_tpu_torch.service import qos as tqos
from ompi_release_tpu_torch.service import tenant as ttenant
from ompi_release_tpu_torch.tools import tpu_top as ttop
from ompi_release_tpu_torch.utils import cids
from ompi_release_tpu_torch.utils.errors import ErrorCode, MPIError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QOS = {"jax": jqos, "torch": tqos}
TENANT = {"jax": (jtenant, julfm), "torch": (ttenant, tulfm)}


def _outcome(fn, *a, **kw):
    """The value, or the error's code name (both packages' MPIError)."""
    try:
        return ("ok", fn(*a, **kw))
    except (MPIError, JMPIError) as e:
        return ("err", e.code.name)


@pytest.fixture(scope="module")
def world():
    return tmpi.init(cli_args=["--mca", "runtime_virtual_ranks", "8"],
                     device="cpu")


# ---------------------------------------------------------------------------
# the cid band
# ---------------------------------------------------------------------------


class TestCidBand:
    def test_counter_stops_below_the_tenant_band(self, monkeypatch):
        base = cids.TENANT_CID_BASE
        monkeypatch.setattr(tcomm_mod, "_cid_counter",
                            itertools.count(base - 3))
        got = [tcomm_mod._next_cid() for _ in range(3)]
        assert got == [base - 3, base - 2, base - 1]
        for _ in range(2):  # and it stays exhausted
            with pytest.raises(MPIError) as ei:
                tcomm_mod._next_cid()
            assert ei.value.code == ErrorCode.ERR_INTERN
        assert all(tulfm.tenant_of_cid(c) == -1 for c in got)

    def test_layout_is_disjoint(self):
        assert cids.TENANT_CID_BASE == 1 << 18 == julfm.TENANT_CID_BASE
        assert tulfm.tenant_band(tulfm.MAX_TENANTS - 1)[1] \
            == cids.CID_BAND == cids.FT_CID_BASE
        assert cids.FT_CID_LIMIT == cids.DPM_CID_BASE
        assert tulfm.MAX_TENANTS == julfm.MAX_TENANTS == 64

    def test_band_math_equals_jax_over_whole_ranges(self):
        for t in range(-2, tulfm.MAX_TENANTS + 2):
            assert _outcome(tulfm.tenant_band, t) \
                == _outcome(julfm.tenant_band, t)
        for t in range(tulfm.MAX_TENANTS):
            for k in range(0, 6000, 13):
                assert tulfm.tenant_cid(t, k) == julfm.tenant_cid(t, k)
        lo = tulfm.TENANT_CID_BASE - 300
        for c in itertools.chain(range(-5, 5), range(lo, lo + 600),
                                 range(cids.FT_CID_BASE - 300,
                                       cids.FT_CID_BASE + 300),
                                 range(lo + 300, cids.FT_CID_BASE, 97)):
            assert tulfm.tenant_of_cid(c) == julfm.tenant_of_cid(c)
        for t in range(tulfm.MAX_TENANTS):
            for epoch in range(20):
                for parent in (0, 1, 255, 256, 257, 4095,
                               tulfm.tenant_cid(t, 3), -7):
                    assert tulfm.ft_cid(epoch, parent, tenant=t) \
                        == julfm.ft_cid(epoch, parent, tenant=t)


# ---------------------------------------------------------------------------
# QoS classes and the arbiter
# ---------------------------------------------------------------------------

SPECS = ["", "latency:8,bulk:2", "latency:8,bulk:2,best_effort:1",
         "a", "a,b:3", " x : 2 , y:0.5 ", "solo:1", "a:1,b:1,c:1,d:1,e:1",
         "hi:100,lo:1", "a:1e-3,b:7", "latency:8,,bulk:2",
         # typed errors
         "a:zero", ":3", "a:-1", "a:0", "a:2,b:nan?"]


class TestQosClasses:
    @pytest.mark.parametrize("spec", SPECS)
    def test_parse_and_shares_equal_jax(self, spec):
        got = {k: _outcome(m.parse_classes, spec) for k, m in QOS.items()}
        assert got["torch"] == got["jax"]
        if got["jax"][0] != "ok":
            return
        classes = got["jax"][1]
        for cls in list(classes) + ["unknown", ""]:
            assert tqos.fair_share(cls, classes) \
                == jqos.fair_share(cls, classes)
        for nlanes in range(0, 20):
            assert tqos.lane_ranges(classes, nlanes) \
                == jqos.lane_ranges(classes, nlanes)


class _FakeCond:
    """The arbiter's condition made single-threaded: ``wait`` runs the
    next scripted action of the other classes (what another thread
    would do while this one parks)."""

    def __init__(self, pending, log):
        self.pending, self.log = pending, log

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def notify_all(self):
        pass

    def wait(self, timeout=None):
        self.log.append("park")
        assert self.pending, "a gate parked with nothing left to run"
        self.pending.pop(0)()


def _arbiter_trace(mod, monkeypatch):
    clock = itertools.count(0.0, 0.25)
    monkeypatch.setattr(mod, "time", NS(perf_counter=lambda: next(clock)))
    arb = mod.WireArbiter(mod.parse_classes("latency:8,bulk:2"),
                          quantum=16.0)
    log = []
    pending = []
    arb._cond = _FakeCond(pending, log)
    from ompi_release_tpu.mca import pvar as jpvar

    waits = (tpvar if mod is tqos else jpvar).PVARS.lookup(
        "wire_qos_gate_waits")

    def spends():
        return (arb.spend("latency"), arb.spend("bulk"), arb.spend(""))

    def step(name, fn, *a, **kw):
        fn(*a, **kw)
        log.append((name, spends()))

    w0 = waits.read()
    step("enter bulk", arb.enter, "bulk")
    for _ in range(6):
        step("gate bulk", arb.gate, "bulk", cost=4)  # alone: never waits
    step("enter latency", arb.enter, "latency")  # catches up, no credit
    for _ in range(3):
        step("gate latency", arb.gate, "latency", cost=4)
    # bulk is ahead by more than quantum / weight: it parks while the
    # latency class runs four more bursts, then leaves
    pending.extend([lambda: step("gate latency", arb.gate, "latency",
                                 cost=4)] * 4
                   + [lambda: step("leave latency", arb.leave, "latency")])
    for _ in range(8):
        step("gate bulk", arb.gate, "bulk", cost=4)
    step("enter best-effort", arb.enter, None)
    step("gate best-effort", arb.gate, None, cost=1)
    step("leave best-effort", arb.leave, None)
    step("leave bulk", arb.leave, "bulk")
    assert not pending
    return log, waits.read() - w0


class TestWireArbiter:
    def test_scripted_sequence_equals_jax(self, monkeypatch):
        jlog, jparks = _arbiter_trace(jqos, monkeypatch)
        tlog, tparks = _arbiter_trace(tqos, monkeypatch)
        assert tlog == jlog
        # two bulk bursts park: the fifth for one latency burst, the
        # sixth through three more and the latency class's leave
        assert tlog.count("park") == 5 and tparks == jparks == 2

    def test_one_arbiter_per_spec(self):
        tqos._reset_for_tests()
        try:
            a = tqos.arbiter_for("latency:8,bulk:2")
            assert tqos.arbiter_for("latency:8,bulk:2") is a
            assert tqos.arbiter_for("latency:1") is not a
            assert a.weight("latency") == 8.0 and a.weight("nope") == 1.0
        finally:
            tqos._reset_for_tests()


# ---------------------------------------------------------------------------
# the tenant registry
# ---------------------------------------------------------------------------

_TIMES = ("age_s", "beat_age_s", "expires_in_s")


def _mask(doc):
    if isinstance(doc, dict):
        return {k: ("<t>" if k in _TIMES else _mask(v))
                for k, v in doc.items() if k != "token"}
    if isinstance(doc, list):
        return [_mask(v) for v in doc]
    return doc


def _registry_script(pkg):
    tenant_mod, ulfm = TENANT[pkg]
    reg = tenant_mod.TenantRegistry(capacity_ranks=16, capacity_lanes=4,
                                    lease_s=30.0, max_tenants=3)
    evictions = []
    reg.add_evict_listener(lambda t, why: evictions.append((t.tid, why)))
    reg.add_evict_listener(lambda t, why: 1 / 0)  # contained
    out = []
    a = reg.admit("trainer-a", 8, qos="latency", lanes=2, owner=11)
    b = reg.admit("trainer-b", 4, qos="bulk", owner=12)
    out.append(("admit", a.tid, b.tid, list(a.band), a.qos))
    for args, kw in ((("trainer-a", 1), {}), (("", 1), {}),
                     (("x", 0), {}), (("big", 8), {}),
                     (("lanes", 1), {"lanes": 9})):
        how, what = _outcome(reg.admit, *args, **kw)
        out.append(("deny", what if how == "err" else "admitted"))
    reg.renew(a.tid, a.token, stats={"coll_s": 120.0, "mb_s": 85.5})
    out.append(("bad token", _outcome(reg.renew, a.tid, "nope")[1]))
    out.append(("unknown", _outcome(reg.renew, 9, a.token)[1]))
    c = reg.admit("short", 2, owner=12, lease_s=0.5)
    out.append(("full", _outcome(reg.admit, "fourth", 1)[1]))
    out.append(("doc1", _mask(reg.doc())))
    now = time.monotonic()
    swept = reg.sweep(now + 1.0)  # only the short lease expired
    out.append(("sweep", [t.tid for t in swept],
                [t.evict_reason.split(" (")[0] for t in swept]))
    st = ulfm.state()
    out.append(("band revoked", st.is_revoked(ulfm.tenant_cid(c.tid, 0)),
                st.is_revoked(ulfm.tenant_cid(a.tid, 0))))
    lost = reg.note_owner_lost(12)
    out.append(("owner lost", [t.tid for t in lost]))
    reg.release(a.tid, a.token)
    out.append(("again", reg.evict(a.tid, "x")))
    d = reg.admit("reuse", 1)  # a freed slot, its band healed
    out.append(("reuse", d.tid, st.is_revoked(ulfm.tenant_cid(d.tid, 0))))
    reg.fail(d.tid, d.token, reason="rank 3 died")
    out.append(("doc2", _mask(reg.doc())))
    out.append(("evictions", evictions))
    for tid in range(3):
        st.clear_band(*ulfm.tenant_band(tid))
    return out


class TestTenantRegistry:
    def test_script_equals_jax(self):
        assert _registry_script("torch") == _registry_script("jax")

    def test_tenant_doc_carries_no_token(self):
        reg = ttenant.TenantRegistry()
        t = reg.admit("x", 1)
        try:
            assert "token" not in t.doc() and t.token not in str(reg.doc())
        finally:
            reg.evict(t.tid, "teardown")
            tulfm.state().clear_band(*t.band)


# ---------------------------------------------------------------------------
# the wire's QoS half
# ---------------------------------------------------------------------------


class _StubRouter:
    def __init__(self, t):
        from ompi_release_tpu_torch.runtime.wire import WireRouter

        self._t = t
        self._class_of = WireRouter._class_of

    def tuning(self):
        return self._t


class _StubComm:
    def __init__(self, cls=None):
        if cls is not None:
            self._qos_class = cls


@pytest.fixture()
def qos_vars():
    from ompi_release_tpu_torch.runtime.wire import WireTuning

    tvar.set_value("wire_p2p_lanes", 8)
    tvar.set_value("wire_qos_classes", "latency:3,bulk:1")
    try:
        yield WireTuning()
    finally:
        for name in ("wire_qos_classes", "wire_qos_class",
                     "wire_p2p_lanes"):
            tvar.VARS.unset(name)
        tqos._reset_for_tests()


class TestWireQos:
    def test_zero_config_is_legacy(self):
        from ompi_release_tpu_torch.runtime.wire import WireRouter, WireTuning

        t = WireTuning()
        assert t.qos_ranges is None and t.arbiter is None
        r = _StubRouter(t)
        for tag in range(40):
            assert WireRouter._lane_of(r, tag, _StubComm("bulk")) \
                == tag % t.lanes

    def test_comm_class_selects_its_lane_range(self, qos_vars):
        from ompi_release_tpu_torch.runtime.wire import WireRouter

        t = qos_vars
        assert t.qos_ranges == jqos.lane_ranges(
            jqos.parse_classes("latency:3,bulk:1"), 8)
        r = _StubRouter(t)
        for cls, (start, count) in t.qos_ranges.items():
            lanes = {WireRouter._lane_of(r, tag, _StubComm(cls))
                     for tag in range(64)}
            assert lanes == set(range(start, start + count))
        # unknown and unstamped classes ride the full range
        assert {WireRouter._lane_of(r, tag, _StubComm("nope"))
                for tag in range(64)} == set(range(8))

    def test_process_default_class_cvar(self, qos_vars):
        from ompi_release_tpu_torch.runtime.wire import WireRouter, WireTuning

        tvar.set_value("wire_qos_class", "bulk")
        t = WireTuning()
        start, count = t.qos_ranges["bulk"]
        r = _StubRouter(t)
        assert WireRouter._class_of(_StubComm(), t) == "bulk"
        assert WireRouter._class_of(_StubComm("latency"), t) == "latency"
        assert {WireRouter._lane_of(r, tag, _StubComm())
                for tag in range(32)} == set(range(start, start + count))

    @pytest.mark.parametrize("counts", [None, (5, 1, 3)])
    def test_stripe_sends_every_frame_through_the_gate(self, counts):
        """Frames of three streams (5, 1 and 3 frames) go out whole and
        in per-stream order; with frozen-plan counts a drained stream
        costs the gate nothing and a short tail is gated at its size."""
        from ompi_release_tpu_torch.runtime.wire import WireRouter

        sent, gates = [], []

        def stream(k, n):
            for i in range(n):
                sent.append((k, i))
                yield

        arb = NS(enter=lambda c: gates.append(("enter", c)),
                 leave=lambda c: gates.append(("leave", c)),
                 gate=lambda c, cost: gates.append(("gate", cost)))
        WireRouter._stripe([stream(0, 5), stream(1, 1), stream(2, 3)], 2,
                           arbiter=arb, cls="bulk", counts=counts)
        assert sorted(sent) == sorted(
            (k, i) for k, n in enumerate((5, 1, 3)) for i in range(n))
        for k in range(3):
            mine = [i for kk, i in sent if kk == k]
            assert mine == sorted(mine)
        assert gates[0] == ("enter", "bulk") and gates[-1] == ("leave",
                                                               "bulk")
        costs = [c for what, c in gates if what == "gate"]
        if counts is None:
            assert costs == [2, 2, 2, 2, 2, 2]  # every burst at depth
        else:
            assert costs == [2, 1, 2, 2, 1, 1]  # tails at their size

    def test_frozen_round_counts_frames(self):
        from ompi_release_tpu_torch.btl import components as tbtl
        from ompi_release_tpu_torch.coll import plan as cplan

        tpl = tbtl.plan_frame_template((1000,), "float32", 1024)
        rnd = cplan.WireRound(((1, (((1000,), "float32"),)),), ((1, 1),),
                              ((1, (tpl,)),), 9, 2,
                              frame_counts=(tpl.nchunks + 1,))
        assert rnd.frame_counts == (5,)  # header + 4 fragments

    def test_native_executor_withdraws_under_the_arbiter(self, qos_vars):
        """With ``wire_qos_classes`` set a replayed plan stays on
        PlannedXchg, so every burst passes the weighted-fair gate."""
        from ompi_release_tpu_torch.coll import native_exec as nx
        from ompi_release_tpu_torch.coll import plan as cplan
        from ompi_release_tpu_torch.runtime.wire import WireTuning

        rnd = cplan.WireRound(((1, (((4,), "int32"),)),), ((1, 1),),
                              ((1, (None,)),), 9, 2)
        st = NS(plan=cplan.WirePlan(0, 1, [rnd], 1000), why=None,
                comm=None)
        router = NS(_nw=object(), tuning=WireTuning)
        fb = tpvar.PVARS.lookup("plan_native_fallbacks")
        f0 = fb.read()
        real = nx.available
        nx.available = lambda: True
        try:
            assert nx.try_compile(st, NS(router=router), None, (), {}) \
                is None
        finally:
            nx.available = real
        assert st.why == "_Ineligible: qos arbiter active"
        assert fb.read() == f0 + 1
        tvar.VARS.unset("wire_qos_classes")
        st.why = None
        nx.available = lambda: True
        try:
            nx.try_compile(st, NS(router=NS(_nw=object(),
                                            tuning=WireTuning)),
                           None, (), {})
        finally:
            nx.available = real
        assert st.why != "_Ineligible: qos arbiter active"


# ---------------------------------------------------------------------------
# real communicators
# ---------------------------------------------------------------------------


class TestBandsOnRealComms:
    def test_band_revoke_hits_only_that_tenants_comm(self, world):
        from ompi_release_tpu_torch.comm.communicator import Communicator

        st = tulfm.state()
        a = Communicator(world.runtime, world.group, name="tenant-a",
                         cid=tulfm.tenant_cid(5, 0))
        b = Communicator(world.runtime, world.group, name="tenant-b",
                         cid=tulfm.tenant_cid(6, 0))
        ones = np.ones((8, 2), np.float32)
        try:
            st.revoke_band(*tulfm.tenant_band(5))
            with pytest.raises(MPIError) as ei:
                a.allreduce(ones)
            assert ei.value.code == ErrorCode.ERR_REVOKED
            np.testing.assert_array_equal(b.allreduce(ones).numpy(),
                                          np.full((8, 2), 8.0))
            np.testing.assert_array_equal(
                world.allreduce(np.ones((8, 1), np.int32)).numpy(),
                np.full((8, 1), 8))
        finally:
            st.clear_band(*tulfm.tenant_band(5))
            st.clear_band(*tulfm.tenant_band(6))
            a._revoked = False
            a.free()
            b.free()

    def test_qos_stamp_is_inherited(self, world):
        c = world.dup("qos-parent")
        assert c.qos_class is None
        c.set_qos_class("bulk")
        child = c.dup("qos-child")
        assert child.qos_class == "bulk"
        child.set_qos_class(None)
        assert child.qos_class is None and c.qos_class == "bulk"
        child.free()
        c.free()


# ---------------------------------------------------------------------------
# the daemon across packages
# ---------------------------------------------------------------------------


def _daemon_session(daemon_mod, client_mod):
    srv = daemon_mod.ServiceDaemon(capacity_ranks=32, capacity_lanes=16,
                                   lease_s=60.0)
    cl = client_mod.ServiceClient("127.0.0.1", srv.port)
    try:
        out = []
        g = cl.admit("lat-job", ranks=4, qos="latency", lanes=2)
        h = cl.admit("bulk-job", ranks=8, qos="bulk")
        out.append(_mask(g) | {"band": g["band"]})
        for fn, args in ((cl.admit, ("lat-job", 1)),
                         (cl.admit, ("huge", 64)),
                         (cl.renew, (g["tid"], "bad-token"))):
            try:
                fn(*args)
                out.append("admitted?")
            except (MPIError, JMPIError) as e:
                out.append(e.code.name)
        cl.renew(g["tid"], g["token"], stats={"coll_s": 57.0})
        cl.publish("svc-a", "port-a")
        out.append(cl.lookup("svc-a"))
        out.append(_mask(cl.release(g["tid"], g["token"])))
        out.append(_mask(cl.fail(h["tid"], h["token"], reason="boom")))
        view = cl.tenants()
        out.append(_mask(view))
        frames = (ttop.render_tenants(view), jtop.render_tenants(view))
        return out, frames
    finally:
        cl.close()
        srv.shutdown()
        for tid in range(4):
            tulfm.state().clear_band(*tulfm.tenant_band(tid))
            julfm.state().clear_band(*julfm.tenant_band(tid))


class TestDaemonAcrossPackages:
    def test_clients_and_daemons_interoperate(self):
        ref, _ = _daemon_session(jdaemon, jdaemon)
        for d, c in ((tdaemon, jdaemon), (jdaemon, tdaemon),
                     (tdaemon, tdaemon)):
            got, (tframe, jframe) = _daemon_session(d, c)
            assert got == ref, (d.__name__, c.__name__)
            assert tframe == jframe
            assert "evicted (boom)" in tframe and "released" in tframe

    def test_tag_numbers_and_secret(self, monkeypatch):
        from ompi_release_tpu.tools import tpu_server as jsrv
        from ompi_release_tpu_torch.tools import tpu_server as tsrv

        assert (tsrv.TAG_METRICS, tsrv.TAG_JOURNAL, tsrv.TAG_SERIES) \
            == (jsrv.TAG_METRICS, jsrv.TAG_JOURNAL, jsrv.TAG_SERIES) \
            == (13, 14, 15)
        assert (tdaemon.TAG_TENANT, tdaemon.TAG_TENANTS) \
            == (jdaemon.TAG_TENANT, jdaemon.TAG_TENANTS) == (16, 17)
        monkeypatch.setenv("OMPITPU_SERVICE_SECRET", "s3cret")
        monkeypatch.setenv("OMPITPU_JOB_SECRET", "job")
        assert tdaemon.service_secret() == b"s3cret"

    def test_malformed_rpc_is_contained(self):
        srv = tdaemon.ServiceDaemon()
        cl = tdaemon.ServiceClient("127.0.0.1", srv.port)
        try:
            with pytest.raises(MPIError) as ei:
                cl._tenant_rpc({"op": "warp"})
            assert ei.value.code == ErrorCode.ERR_ARG
            g = cl.admit("ok", 1)  # the daemon still serves
            cl.release(g["tid"], g["token"])
        finally:
            cl.close()
            srv.shutdown()
            tulfm.state().clear_band(*tulfm.tenant_band(0))

    def test_lease_expiry_evicted_by_the_serve_loop(self):
        srv = tdaemon.ServiceDaemon(lease_s=0.3)
        cl = tdaemon.ServiceClient("127.0.0.1", srv.port)
        try:
            g = cl.admit("silent", 2)
            t_end = time.monotonic() + 10
            while srv.registry.live() and time.monotonic() < t_end:
                time.sleep(0.05)
            view = cl.tenants()
            assert view["tenants"] == []
            assert view["evicted"][0]["evict_reason"].startswith(
                "lease expired")
            assert tulfm.state().is_revoked(tulfm.tenant_cid(g["tid"], 0))
        finally:
            cl.close()
            srv.shutdown()
            tulfm.state().clear_band(*tulfm.tenant_band(0))

    def test_cli_prints_its_uri_and_serves(self):
        import subprocess

        p = subprocess.Popen(
            [sys.executable, "-m", "ompi_release_tpu_torch.service.daemon",
             "--bind", "127.0.0.1", "--lease", "5"], cwd=REPO,
            stdout=subprocess.PIPE, text=True)
        try:
            line = p.stdout.readline()
            assert line.startswith("tpu-serviced URI: 127.0.0.1:")
            port = int(line.rsplit(":", 1)[1])
            cl = jdaemon.ServiceClient("127.0.0.1", port)
            try:
                assert cl.tenants()["tenants"] == []
            finally:
                cl.close()
        finally:
            p.send_signal(signal.SIGINT)
            assert p.wait(timeout=20) == 0


# ---------------------------------------------------------------------------
# the two-jobs episode on the CPU
# ---------------------------------------------------------------------------

APP_PRELUDE = textwrap.dedent("""
    import os, sys, time
    sys.path.insert(0, %r)
    import numpy as np
    import ompi_release_tpu_torch as mpi
    from ompi_release_tpu_torch.comm.communicator import Communicator
    from ompi_release_tpu_torch.ft import ulfm as _ulfm
    from ompi_release_tpu_torch.runtime.runtime import Runtime
    from ompi_release_tpu_torch.service.daemon import ServiceClient

    world = mpi.init(cli_args=["--mca", "runtime_virtual_ranks", "2"],
                     device="cpu")
    rt = Runtime.current()
    me = rt.bootstrap["process_index"]
    _h, _p = os.environ["OMPITPU_SERVICED"].rsplit(":", 1)

    def attach(name, qos):
        cl = token = None
        contrib = np.zeros((2, 1), np.int32)
        if me == 0:
            cl = ServiceClient(_h, int(_p))
            g = cl.admit(name, ranks=world.size, qos=qos)
            contrib[0, 0] = g["tid"] + 1
            token = g["token"]
        tid = int(world.allreduce(contrib)[0, 0]) - 1
        tcomm = Communicator(rt, world.group, name=f"t{tid}",
                             cid=_ulfm.tenant_cid(tid, 0))
        tcomm.set_qos_class(qos)
        return cl, tid, token, tcomm
""" % REPO)


def _write_app(tmp_path, name, body):
    app = tmp_path / name
    app.write_text(APP_PRELUDE + textwrap.dedent(body))
    return app


class TestServiceJobs:
    def test_two_jobs_one_daemon_kill_isolation(self, tmp_path, capfd):
        """Two port jobs attach to one daemon as tenants; a bulk-tenant
        worker is SIGKILLed mid-allreduce: its survivors get the typed
        ULFM error on their tenant-band cid and report the failure; the
        latency tenant's collectives, renewals and release, and the
        daemon, finish clean; ``tpu_top --tenants`` shows both."""
        from ompi_release_tpu_torch.tools.tpurun import Job

        bulk_app = _write_app(tmp_path, "bulk_app.py", """
            cl, tid, token, tcomm = attach("bulk-job", "bulk")
            world.barrier()
            time.sleep(0.5)
            x = np.stack([np.full(256, me * 2 + i + 1.0, np.float32)
                          for i in range(2)])
            err = None
            for step in range(40):
                if me == 2 and step == 10:
                    import signal
                    os.kill(os.getpid(), signal.SIGKILL)
                try:
                    tcomm.allreduce(x)
                    time.sleep(0.02)
                except mpi.MPIError as e:
                    err = e
                    break
            assert err is not None, "kill never surfaced"
            assert err.code in (mpi.ErrorCode.ERR_PROC_FAILED,
                                mpi.ErrorCode.ERR_REVOKED), err
            assert _ulfm.tenant_of_cid(tcomm.cid) == tid
            if me == 0:
                cl.fail(tid, token, reason="rank 2 died mid-allreduce")
                cl.close()
            print(f"BULK_TYPED_OK rank{me}", flush=True)
            mpi.finalize()
        """)
        lat_app = _write_app(tmp_path, "lat_app.py", """
            cl, tid, token, tcomm = attach("lat-job", "latency")
            x = np.stack([np.arange(64, dtype=np.float32) * (me + i + 1)
                          for i in range(2)])
            want = None
            t0 = time.monotonic()
            for step in range(40):
                out = tcomm.allreduce(x).numpy()
                if want is None:
                    want = out.copy()
                assert np.array_equal(out, want)
                if me == 0 and step % 10 == 0:
                    cl.renew(tid, token, stats={
                        "coll_s": (step + 1)
                        / max(time.monotonic() - t0, 1e-9)})
            assert _ulfm.tenant_of_cid(tcomm.cid) == tid
            if me == 0:
                cl.release(tid, token)
                cl.close()
            print(f"LAT_CLEAN_OK rank{me}", flush=True)
            mpi.finalize()
        """)
        srv = tdaemon.ServiceDaemon(capacity_ranks=32, capacity_lanes=16,
                                    lease_s=60.0)
        env_keep = dict(os.environ)
        os.environ["OMPITPU_SERVICED"] = f"127.0.0.1:{srv.port}"
        # one control-plane secret for both jobs, set before either
        # Job reads it from the environment
        os.environ["OMPITPU_JOB_SECRET"] = "two-tenant-test"
        qos_mca = [("wire_qos_classes", "latency:8,bulk:2")]
        results = {}
        try:
            def run(name, app, n, **kw):
                job = Job(n, [sys.executable, str(app)], list(qos_mca),
                          heartbeat_s=0.3, miss_limit=3, **kw)
                results[name] = (job.run(timeout_s=240), job)

            tb = threading.Thread(target=run, args=(
                "bulk", bulk_app, 3), kwargs={"on_failure": "continue"})
            tl = threading.Thread(target=run, args=("lat", lat_app, 2))
            tb.start()
            tl.start()
            tb.join(timeout=260)
            tl.join(timeout=260)
            assert not tb.is_alive() and not tl.is_alive()
            out = capfd.readouterr()
            text = out.out + out.err
            rc_bulk, job_bulk = results["bulk"]
            rc_lat, _job_lat = results["lat"]
            assert rc_bulk == 0, text
            assert rc_lat == 0, text
            assert text.count("BULK_TYPED_OK") == 2, text
            assert "BULK_TYPED_OK rank2" not in text
            assert text.count("LAT_CLEAN_OK") == 2, text
            assert job_bulk._ft_failed_ranks, "no promoted corpse"

            client = tdaemon.ServiceClient("127.0.0.1", srv.port)
            try:
                view = client.tenants()
            finally:
                client.close()
            assert view["tenants"] == []
            by_name = {t["name"]: t for t in view["evicted"]}
            assert by_name["bulk-job"]["evict_reason"] \
                == "rank 2 died mid-allreduce"
            assert by_name["lat-job"]["evict_reason"] == "released"
            assert by_name["lat-job"]["stats"].get("coll_s", 0) > 0
            frame = ttop.render_tenants(view)
            assert "rank 2 died mid-allreduce" in frame
            assert "released" in frame
            st = tulfm.state()
            assert st.is_revoked(tulfm.tenant_cid(
                by_name["bulk-job"]["tid"], 0))
            assert not st.is_revoked(0)
        finally:
            os.environ.clear()
            os.environ.update(env_keep)
            for t in srv.registry.live():
                srv.registry.evict(t.tid, "teardown")
            srv.shutdown()
            for tid in range(4):
                tulfm.state().clear_band(*tulfm.tenant_band(tid))
