"""The port's fault tolerance (``ft/ulfm.py``, ``ft/sensor.py``,
``ft/errmgr.py``, the coordinator's ULFM plane, ``p2p/vprotocol.py``,
``parallel/elastic.py``, tpurun's FT flags) held against the JAX
package, in one process.

Every case runs the same script through both packages (``pkg``
parametrises ``jax`` and ``torch``) and asserts the same outcome, or
runs both and compares what they return: the failure picture after a
sequence of notices, revocation, the tenant-band math, the progress
engine's ``fail_queued``, the seeded/every-N/armed-kill ``FtTester``,
the HNP's heartbeat promotion, restart grace and agreements,
``respawn_ready``, the dpm fast-fail paths, the ``--ft-*`` plumbing,
``ElasticStep``'s local rollback, the pessimist log's replay and the
sensor/errmgr cases of ``tests/test_io_ft.py:275-345``.

The port lays its cid space out its own way (``utils/cids.py``:
``ft_cid`` takes the lower half of ``[1 << 19, 1 << 20)``, dpm's cid
blocks the upper half), so ``ft_cid`` values are held to the port's own
contract — deterministic, distinct per parent at one epoch, a dpm
lineage never on a shared lineage's slot, disjoint from every dpm
block — and not to the JAX package's numbers. A revoked or evicted comm's frozen
plans are dropped, and a rebuild on its cid records afresh.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import ompi_release_tpu as jmpi
import ompi_release_tpu_torch as tmpi
from ompi_release_tpu.ft import errmgr as jerrmgr
from ompi_release_tpu.ft import sensor as jsensor
from ompi_release_tpu.ft import ulfm as julfm
from ompi_release_tpu.mca import pvar as jpvar
from ompi_release_tpu.mca import var as jvar
from ompi_release_tpu.p2p import vprotocol as jvprotocol
from ompi_release_tpu.runtime import coordinator as jcoord
from ompi_release_tpu.runtime import progress as jprogress
from ompi_release_tpu.tools import tpurun as jtpurun
from ompi_release_tpu.utils.errors import ErrorCode as JErrorCode
from ompi_release_tpu.utils.errors import MPIError as JMPIError
from ompi_release_tpu_torch.ft import errmgr as terrmgr
from ompi_release_tpu_torch.ft import sensor as tsensor
from ompi_release_tpu_torch.ft import ulfm as tulfm
from ompi_release_tpu_torch.mca import pvar as tpvar
from ompi_release_tpu_torch.mca import var as tvar
from ompi_release_tpu_torch.p2p import vprotocol as tvprotocol
from ompi_release_tpu_torch.runtime import coordinator as tcoord
from ompi_release_tpu_torch.runtime import progress as tprogress
from ompi_release_tpu_torch.runtime import runtime as trt
from ompi_release_tpu_torch.tools import tpurun as ttpurun
from ompi_release_tpu_torch.utils.errors import ErrorCode, MPIError

N = 8


class _Pkg:
    def __init__(self, name, **mods):
        self.name = name
        self.__dict__.update(mods)


PKGS = {
    "jax": _Pkg("jax", ulfm=julfm, sensor=jsensor, errmgr=jerrmgr,
                pvar=jpvar, var=jvar, coord=jcoord, progress=jprogress,
                tpurun=jtpurun, vprotocol=jvprotocol, Err=JMPIError,
                Code=JErrorCode),
    "torch": _Pkg("torch", ulfm=tulfm, sensor=tsensor, errmgr=terrmgr,
                  pvar=tpvar, var=tvar, coord=tcoord, progress=tprogress,
                  tpurun=ttpurun, vprotocol=tvprotocol, Err=MPIError,
                  Code=ErrorCode),
}


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture
def ft_states():
    """Clean process-local failure pictures in both packages."""
    for p in PKGS.values():
        p.ulfm.state().reset()
    yield {k: p.ulfm.state() for k, p in PKGS.items()}
    for p in PKGS.values():
        p.ulfm.state().reset()


@pytest.fixture(scope="module")
def worlds():
    jworld = jmpi.init()
    trt._reset_for_tests()
    tworld = tmpi.init(cli_args=["--mca", "runtime_virtual_ranks", str(N)],
                       device="cpu")
    yield {"jax": jworld, "torch": tworld}
    trt._reset_for_tests()
    tvar.VARS.unset("runtime_virtual_ranks")


def _code(fn):
    """The error code name ``fn()`` raises (None if it returns)."""
    try:
        fn()
    except (MPIError, JMPIError) as e:
        return e.code.name
    return None


def _pv(p, name):
    return float(p.pvar.PVARS.lookup(name).read())


# ---------------------------------------------------------------------------
# the failure picture
# ---------------------------------------------------------------------------

#: one job's life as its notices tell it: a failure, a respawn grant, a
#: rejoin, a stale reordered notice, a second failure, and a TAG_FT
#: reply carrying the coordinator's episode record
NOTICES = [
    {"epoch": 1, "failed": [2]},
    {"epoch": 2, "failed": [2]},
    {"epoch": 3, "failed": [], "restarted": [2]},
    {"epoch": 1, "failed": [0]},
    {"epoch": 4, "failed": [], "restarted": [2], "rejoined": [2]},
    {"epoch": 6, "failed": [2], "restarted": [2], "rejoined": [2]},
    {"epoch": 7, "failed": [], "restarted": [1, 2], "rejoined": [2],
     "failed_at": {"1": 7, "2": "bad", "x": 3}},
    {"epoch": "garbled"},
]


class TestFtState:
    def test_error_codes_match(self):
        for name in ("ERR_PROC_FAILED", "ERR_REVOKED"):
            assert int(getattr(ErrorCode, name)) == int(
                getattr(JErrorCode, name))
        assert ErrorCode.ERR_PROC_FAILED != ErrorCode.ERR_REVOKED

    def test_notice_sequence_matches(self, ft_states):
        """Both pictures after each notice, every peer's deadness for
        comms born at each epoch, and the check_wait verdicts agree."""
        base = {k: _pv(p, "ft_failures_detected") for k, p in PKGS.items()}
        for doc in NOTICES:
            seen = {}
            for k, st in ft_states.items():
                st.apply_notice(dict(doc))
                snap = st.snapshot()
                dead = {e0: st.dead_for([0, 1, 2, 3], epoch0=e0)
                        for e0 in range(8)}
                verdicts = [_code(lambda: st.check_wait(
                    5, [p], "reap", epoch0=e0))
                    for p in range(4) for e0 in range(8)]
                peer = [_code(lambda: st.check_peer(p, "send", e0))
                        for p in range(4) for e0 in range(8)]
                seen[k] = (snap, dead, verdicts, peer)
            assert seen["jax"] == seen["torch"], doc
        got = {k: _pv(p, "ft_failures_detected") - base[k]
               for k, p in PKGS.items()}
        # pidx 2 once; pidx 1 arrives only in an episode record, which
        # is not a notice of failure
        assert got["jax"] == got["torch"] == 1

    def test_revoke_marks_raises_and_counts(self, ft_states, pkg):
        st = ft_states[pkg.name]
        base = _pv(pkg, "ft_revokes")
        assert st.apply_revoke(7, 1) is True
        assert st.apply_revoke(7, 1) is False  # idempotent
        assert st.is_revoked(7) and not st.is_revoked(8)
        assert _code(lambda: st.check_wait(7, [0], "reap")) \
            == "ERR_REVOKED"
        assert _pv(pkg, "ft_revokes") == base + 1
        st.clear_revoked(7)
        assert not st.is_revoked(7)

    def test_band_revocation_matches(self, ft_states):
        out = {}
        for k, p in PKGS.items():
            st = ft_states[k]
            lo, hi = p.ulfm.tenant_band(3)
            st.revoke_band(lo, hi, 2)
            r = [st.is_revoked(c) for c in (lo - 1, lo, hi - 1, hi)]
            code = _code(lambda: st.check_wait(lo + 5, [0], "w"))
            st.clear_band(lo, hi)
            out[k] = (r, code, st.is_revoked(lo), st.snapshot())
        assert out["jax"] == out["torch"]
        assert out["torch"][0] == [False, True, True, False]

    def test_tenant_band_math_matches(self):
        for t in (0, 1, 17, 63):
            assert tulfm.tenant_band(t) == julfm.tenant_band(t)
            for k in (0, 5, 2047, 2048, 9999):
                assert tulfm.tenant_cid(t, k) == julfm.tenant_cid(t, k)
            for e in (0, 3, 8, 11):
                for par in (0, 7, 300):
                    assert (tulfm.ft_cid(e, par, tenant=t)
                            == julfm.ft_cid(e, par, tenant=t))
        for cid in (-4, 0, 1 << 18, (1 << 18) + 4096 * 5 + 1,
                    (1 << 19) - 1, 1 << 19):
            assert tulfm.tenant_of_cid(cid) == julfm.tenant_of_cid(cid)
        for p in PKGS.values():
            with pytest.raises(p.Err):
                p.ulfm.tenant_band(64)

    def test_failed_at_of_matches(self):
        for doc in (None, {}, {"failed_at": {"2": 5, "bad": "x",
                                             "1": "3"}}):
            assert tulfm.failed_at_of(doc) == julfm.failed_at_of(doc)
        assert tulfm.failed_at_of(
            {"failed_at": {"2": 5, "bad": "x", "1": "3"}}) == {2: 5, 1: 3}

    def test_listener_sees_notices_and_revokes(self, ft_states):
        st = ft_states["torch"]
        seen = []
        st.add_listener(seen.append)
        try:
            st.apply_notice({"epoch": 1, "failed": [1]})
            st.apply_revoke(12, 1)
            st.apply_revoke(12, 1)  # not a change: no second call
        finally:
            st._listeners.remove(seen.append)
        assert seen == [{"epoch": 1, "failed": [1]}, {"revoked": 12}]

    def test_postmortem_awaiting_names_known_failed(self, ft_states):
        from ompi_release_tpu.runtime.wire import (
            _ft_split_awaiting as jsplit,
        )
        from ompi_release_tpu_torch.runtime.wire import (
            _ft_split_awaiting as tsplit,
        )

        for st in ft_states.values():
            st.apply_notice({"epoch": 1, "failed": [2]})
        assert tsplit([1, 2, 3]) == jsplit([1, 2, 3]) == {
            "awaiting_procs": [1, 3], "known_failed_procs": [2]}

    def test_finish_checked_respects_comm_epoch(self, ft_states,
                                                worlds):
        """A rejoined replacement's flaky transfer on a POST-recovery
        comm stays a flake; on a pre-failure comm it is the typed
        process failure — in both packages."""
        from ompi_release_tpu.runtime.wire import WireRouter as JRouter
        from ompi_release_tpu_torch.runtime.wire import (
            WireRouter as TRouter,
        )

        out = {}
        for k, cls in (("jax", JRouter), ("torch", TRouter)):
            p = PKGS[k]

            def boom(self, *a, _p=p, **kw):
                raise _p.Err(_p.Code.ERR_TRUNCATE, "flaky tail")

            st = ft_states[k]
            st.apply_notice({"epoch": 1, "failed": [2]})
            st.apply_notice({"epoch": 3, "failed": [],
                             "restarted": [2], "rejoined": [2]})
            router = cls.__new__(cls)
            router._finish_transfer = boom.__get__(router)
            out[k] = [_code(lambda: router._finish_checked(
                2, 0, b"", 0.0, epoch0=e)) for e in (0, 3)]
        assert out["jax"] == out["torch"] == ["ERR_PROC_FAILED",
                                              "ERR_TRUNCATE"]


# ---------------------------------------------------------------------------
# the cid layout and the explicit-cid constructor
# ---------------------------------------------------------------------------

class TestCidLayout:
    def test_ft_cid_deterministic_bounded_distinct(self):
        a = tulfm.ft_cid(3, 0)
        assert a == tulfm.ft_cid(3, 0)
        assert a != tulfm.ft_cid(4, 0) and a != tulfm.ft_cid(3, 1)
        assert tulfm.FT_CID_BASE <= a < tulfm.FT_CID_LIMIT
        minted = {tulfm.ft_cid(5, c) for c in range(200)}
        assert len(minted) == 200
        assert tulfm.ft_cid(5, 2) != tulfm.ft_cid(5, 66)
        # the wrap lands on the same lineage's slot FT_CID_EPOCHS later
        assert tulfm.ft_cid(1 + tulfm.FT_CID_EPOCHS, 7) == \
            tulfm.ft_cid(1, 7)

    def test_ft_cids_and_dpm_blocks_disjoint(self):
        """Every ft_cid over one epoch wrap (two wraps of epochs x every
        parent slot of both halves) and every dpm CidBlock the port's
        owners can reserve lie in disjoint bands, above the shared
        counter and below the wire's bound."""
        from ompi_release_tpu_torch.comm.communicator import CidBlock
        from ompi_release_tpu_torch.utils.cids import (
            CID_BAND, CID_LIMIT, DPM_CID_BASE, DPM_CID_BLOCK,
            DPM_CID_BLOCKS, dpm_block_base,
        )

        half = tulfm.FT_CID_SLOTS // 2
        parents = list(range(half)) + [DPM_CID_BASE + k
                                       for k in range(half)]
        ft = {tulfm.ft_cid(e, p) for e in range(2 * tulfm.FT_CID_EPOCHS)
              for p in parents}
        assert len(ft) == tulfm.FT_CID_EPOCHS * tulfm.FT_CID_SLOTS
        assert min(ft) == CID_BAND and max(ft) == DPM_CID_BASE - 1
        blocks = [CidBlock(dpm_block_base(k), DPM_CID_BLOCK)
                  for k in range(DPM_CID_BLOCKS)]
        assert len(blocks) == 1024
        dpm_cids = set()
        for b in blocks:
            dpm_cids.update(range(b.base, b.base + b.size))
        assert len(dpm_cids) == 1024 * 256
        assert not ft & dpm_cids
        assert max(dpm_cids) == CID_LIMIT - 1
        # a block may not reach into the FT band, nor past the last one
        with pytest.raises(MPIError):
            CidBlock(DPM_CID_BASE - 256, 256)
        with pytest.raises(MPIError):
            dpm_block_base(DPM_CID_BLOCKS)

    def test_counter_stops_at_the_tenant_band(self, worlds, ft_states,
                                              monkeypatch):
        """A comm created at the shared counter's limit raises
        ERR_INTERN instead of taking tenant 0's first cid, and a
        tenant-band revoke leaves every counter cid alone."""
        import itertools

        from ompi_release_tpu_torch.comm import communicator as tcm
        from ompi_release_tpu_torch.utils.cids import TENANT_CID_BASE

        world = worlds["torch"]
        monkeypatch.setattr(tcm, "_cid_counter",
                            itertools.count(TENANT_CID_BASE - 1))
        last = world.dup("last-counter-cid")
        assert last.cid == TENANT_CID_BASE - 1
        assert _code(lambda: world.dup("past-the-limit")) == "ERR_INTERN"
        st = ft_states["torch"]
        try:
            for t in (0, tulfm.MAX_TENANTS - 1):
                st.revoke_band(*tulfm.tenant_band(t))
            assert st.is_revoked(tulfm.tenant_cid(0, 0))
            assert not any(st.is_revoked(c) for c in itertools.chain(
                range(0, 4096), range(TENANT_CID_BASE - 4096,
                                      TENANT_CID_BASE)))
            assert not last._revoked and not world._revoked
            out = last.allreduce(np.ones((N, 1), np.float32))
            np.testing.assert_array_equal(out.numpy(), np.full((N, 1), N))
        finally:
            last.free()

    @pytest.mark.parametrize("epoch", [0, 5])
    def test_dpm_lineage_never_shares_a_shared_lineages_slot(self, epoch):
        """Rebuilding a shared-counter comm and a dpm pair's comm in one
        epoch (the shrink-every-comm pattern) gives two cids: no dpm
        lineage takes the slot of any lineage outside the dpm band."""
        from ompi_release_tpu_torch.utils.cids import (
            CID_BAND, CID_LIMIT, DPM_CID_BASE, DPM_CID_BLOCK,
        )

        for k in range(DPM_CID_BLOCK):
            assert tulfm.ft_cid(epoch, k) != \
                tulfm.ft_cid(epoch, DPM_CID_BASE + k)
        shared = {tulfm.ft_cid(epoch, p)
                  for p in range(-4096, CID_BAND)}
        dpm_ft = {tulfm.ft_cid(epoch, p)
                  for p in range(DPM_CID_BASE, CID_LIMIT)}
        assert not shared & dpm_ft
        assert len(shared) == len(dpm_ft) == tulfm.FT_CID_SLOTS // 2

    def test_dpm_blocks_start_above_the_ft_band(self, monkeypatch):
        """``_new_cid_block`` reserves block ``n * nproc + pidx`` from
        DPM_CID_BASE up."""
        from ompi_release_tpu_torch.comm import dpm
        from ompi_release_tpu_torch.utils.cids import (
            DPM_CID_BASE, DPM_CID_BLOCK,
        )

        rt = type("R", (), {"agent": object(),
                            "bootstrap": {"process_index": 1,
                                          "process_count": 3}})()
        monkeypatch.setattr(dpm, "_runtime", lambda: rt)
        monkeypatch.setattr(dpm, "_block_counter", iter(range(4)))
        blk = dpm._new_cid_block()
        assert blk.base == DPM_CID_BASE + 1 * DPM_CID_BLOCK
        assert blk.base >= tulfm.FT_CID_LIMIT

    def test_rebuild_evicts_revoked_slot_occupant(self, worlds,
                                                  ft_states):
        """An epoch-wrapped ft cid landing on this lineage's OLD
        revoked comm evicts it; a LIVE occupant stays a loud error; a
        stale revocation record never poisons the fresh comm — the JAX
        package's contract (``tests/test_ft_ulfm.py:132``)."""
        from ompi_release_tpu_torch.comm.communicator import (
            Communicator, _comm_registry,
        )
        from ompi_release_tpu_torch.comm.group import Group

        world = worlds["torch"]
        slot = tulfm.ft_cid(1, 0)
        old = Communicator(world.runtime, Group([0, 1]), name="old",
                           cid=slot)
        with pytest.raises(MPIError) as ei:
            Communicator(world.runtime, Group([0, 1]), cid=slot)
        assert ei.value.code == ErrorCode.ERR_COMM
        old._revoked = True
        tulfm.state().apply_revoke(slot, 1)
        new = Communicator(world.runtime, Group([0, 1]), name="new",
                           cid=slot)
        assert _comm_registry[slot] is new and old._freed
        assert not tulfm.state().is_revoked(slot)
        new.free()
        tulfm.state().apply_revoke(slot, 2)  # revoked-then-freed long ago
        again = Communicator(world.runtime, Group([0, 1]),
                             name="again", cid=slot)
        assert not tulfm.state().is_revoked(slot)
        again.free()

    def test_lineage_anchor_survives_rebuild_chain(self, worlds):
        from ompi_release_tpu_torch.comm.communicator import Communicator
        from ompi_release_tpu_torch.comm.group import Group

        world = worlds["torch"]
        base = Communicator(world.runtime, Group([0, 1]), name="base")
        r1 = Communicator(world.runtime, Group([0, 1]), parent=base,
                          cid=tulfm.ft_cid(1, base._ft_lineage))
        r2 = Communicator(world.runtime, Group([0, 1]), parent=r1,
                          cid=tulfm.ft_cid(2, r1._ft_lineage))
        assert base._ft_lineage == r1._ft_lineage == r2._ft_lineage \
            == base.cid
        assert tulfm.ft_cid(3, r1._ft_lineage) == \
            tulfm.ft_cid(3, base._ft_lineage)
        for c in (r2, r1, base):
            c.free()

    def test_revoke_drops_plans_and_rebuild_records_fresh(self, worlds,
                                                          ft_states):
        """A revoked comm's frozen plans go at once (their pool with
        them), its collectives refuse with ERR_REVOKED, and a rebuild
        on the same cid records a fresh plan instead of replaying the
        dead comm's."""
        from ompi_release_tpu_torch.coll import plan
        from ompi_release_tpu_torch.comm.communicator import Communicator
        from ompi_release_tpu_torch.comm.group import Group

        world = worlds["torch"]
        slot = tulfm.ft_cid(9, 123)
        x = np.arange(4 * 3, dtype=np.float32).reshape(4, 3)
        old = Communicator(world.runtime, Group([0, 1, 2, 3]),
                           name="doomed", cid=slot)
        want = old.allreduce(x).clone()
        old.allreduce(x)
        mine = [k for k in plan._device_plans if k[0] == slot]
        assert mine
        first = plan._device_plans[mine[0]]
        plan._pools[slot] = "pool"  # a graph pool, as on the card
        old.revoke()
        assert old.revoked
        assert not [k for k in plan._device_plans if k[0] == slot]
        assert slot not in plan._pools
        with pytest.raises(MPIError) as ei:
            old.allreduce(x)
        assert ei.value.code == ErrorCode.ERR_REVOKED
        with pytest.raises(MPIError) as ei:
            old.send(x[0], dest=1, rank=0)
        assert ei.value.code == ErrorCode.ERR_REVOKED
        new = Communicator(world.runtime, Group([0, 1, 2, 3]),
                           name="rebuilt", cid=slot, parent=old)
        assert old._freed
        got = new.allreduce(x)
        assert torch.equal(got, want)
        again = plan._device_plans[mine[0]]
        assert again is not first and again.get("frozen") is not None
        new.free()
        assert not [k for k in plan._device_plans if k[0] == slot]

    def test_sendrecv_and_icoll_refuse_revoked_comm(self, worlds):
        world = worlds["torch"]
        c = world.dup("sr-revoked")
        c._revoked = True
        for fn in (lambda: c.sendrecv([np.zeros(2)] * c.size,
                                      list(range(c.size))),
                   lambda: c.iallreduce(np.zeros((c.size, 2))),
                   lambda: c.ibarrier(),
                   lambda: c.recv(source=0, rank=1)):
            assert _code(fn) == "ERR_REVOKED"
        # agree/shrink/get_failed stay usable on a revoked comm
        assert c.agree(True) is True and c.get_failed() == []
        s = c.shrink()
        assert s.size == c.size and not s.revoked
        s.free()
        c._revoked = False
        c.free()


# ---------------------------------------------------------------------------
# progress engine: revoke interrupts queued schedules
# ---------------------------------------------------------------------------

class TestFailQueued:
    def test_queued_ops_complete_in_error_without_running(self, pkg):
        eng = pkg.progress.ProgressEngine()
        ran = []
        blocker = pkg.progress.ScheduledOp(
            ("comm", 42), "blocker", lambda: ran.append("b"))
        victim = pkg.progress.ScheduledOp(
            ("comm", 42), "victim", lambda: ran.append("v"))
        eng.post(blocker)
        eng.post(victim)
        n = eng.fail_queued(
            ("comm", 42),
            lambda: pkg.Err(pkg.Code.ERR_REVOKED, "revoked"))
        assert n == 2 and not ran
        assert victim.done.is_set()
        assert victim.error.code == pkg.Code.ERR_REVOKED
        with pytest.raises(pkg.Err):
            eng.wait(victim)
        assert eng.inflight_count() == 0

    def test_running_op_untouched(self, pkg):
        eng = pkg.progress.ProgressEngine()
        started = threading.Event()
        release = threading.Event()

        def slow():
            started.set()
            release.wait(5)
            return "done"

        op = pkg.progress.ScheduledOp(("comm", 43), "slow", slow)
        eng.post(op)
        t = threading.Thread(target=eng.wait, args=(op,), daemon=True)
        t.start()
        assert started.wait(5)
        assert eng.fail_queued(("comm", 43), lambda: pkg.Err(
            pkg.Code.ERR_REVOKED, "r")) == 0
        release.set()
        t.join(5)
        assert op.error is None and op.result == "done"

    def test_apply_revoke_sweeps_the_engine(self, ft_states):
        """The port's apply_revoke fails the cid's queued schedules on
        the process engine, as the JAX package's does."""
        eng = tprogress.engine()
        ran = []
        blocker = tprogress.ScheduledOp(("comm", 4242), "b",
                                        lambda: ran.append("b"))
        victim = tprogress.ScheduledOp(("comm", 4242), "v",
                                       lambda: ran.append("v"))
        eng.post(blocker)
        eng.post(victim)
        ft_states["torch"].apply_revoke(4242, 0)
        assert victim.done.wait(5) and not ran
        assert victim.error.code == ErrorCode.ERR_REVOKED


# ---------------------------------------------------------------------------
# sensor: seeded / every-N / armed-kill injection, heartbeats
# ---------------------------------------------------------------------------

def _injections(tester, n):
    out = []
    for i in range(n):
        try:
            tester.maybe_fail(f"c{i}")
            out.append(0)
        except (tsensor.InjectedFault, jsensor.InjectedFault):
            out.append(1)
    return out


class TestFtTester:
    def test_seed_reproducible_across_packages(self):
        got = [_injections(p.sensor.FtTester(fail_prob=0.5, seed=1234),
                           64) for p in PKGS.values()]
        assert got[0] == got[1] and 0 < sum(got[0]) < 64
        other = _injections(tsensor.FtTester(fail_prob=0.5, seed=99), 64)
        assert other != got[1]

    def test_seed_cvar_feeds_default(self, pkg):
        pkg.var.set_value("sensor_ft_seed", 77)
        try:
            t = pkg.sensor.FtTester(fail_prob=0.5)
            assert t.seed == 77
            a = _injections(t, 32)
        finally:
            pkg.var.VARS.unset("sensor_ft_seed")
        assert a == _injections(pkg.sensor.FtTester(fail_prob=0.5,
                                                    seed=77), 32)

    def test_every_n_deterministic(self, pkg):
        t = pkg.sensor.FtTester(fail_prob=0.0, every_n=3)
        fired = []
        for s in range(10):
            try:
                t.step()
            except pkg.sensor.InjectedFault:
                fired.append(s)
        assert fired == [3, 6, 9] and t.injected == 3

    def test_kill_armed_at_step(self, pkg, monkeypatch):
        kills = []
        monkeypatch.setattr(os, "kill", lambda pid, sig: kills.append(
            (pid, sig)))
        t = pkg.sensor.FtTester(fail_prob=0.0, kill_step=2)
        for _ in range(4):
            t.step()
        import signal

        assert kills == [(os.getpid(), signal.SIGKILL)]

    def test_from_cvars_rank_scoping(self, pkg):
        pkg.var.set_value("sensor_ft_kill_step", 5)
        pkg.var.set_value("sensor_ft_kill_rank", 1)
        try:
            assert pkg.sensor.FtTester.from_cvars(1).kill_step == 5
            assert pkg.sensor.FtTester.from_cvars(0).kill_step == -1
        finally:
            pkg.var.VARS.unset("sensor_ft_kill_step")
            pkg.var.VARS.unset("sensor_ft_kill_rank")
        assert pkg.sensor.FtTester.from_cvars(1).kill_step == -1

    def test_cvars_registered_alike(self):
        names = ("sensor_ft_tester_prob", "sensor_ft_seed",
                 "sensor_ft_every_n", "sensor_ft_kill_step",
                 "sensor_ft_kill_rank", "sensor_heartbeat_interval")
        for n in names:
            assert tvar.VARS.lookup(n).default == \
                jvar.VARS.lookup(n).default


class TestSensors:
    """``tests/test_io_ft.py``'s TestSensors, on both packages."""

    def test_heartbeat_detects_silence(self, pkg):
        fired = []
        hb = pkg.sensor.Heartbeat(interval_s=0.05, miss_limit=2,
                                  on_failure=lambda: fired.append(1))
        hb.start()
        hb.beat()
        time.sleep(0.3)
        hb.stop()
        assert hb.failed and fired

    def test_heartbeat_stays_alive_with_beats(self, pkg):
        hb = pkg.sensor.Heartbeat(interval_s=0.05, miss_limit=3).start()
        for _ in range(10):
            hb.beat()
            time.sleep(0.02)
        assert not hb.failed
        hb.stop()

    def test_ft_tester_deterministic(self, pkg):
        t = pkg.sensor.FtTester(fail_prob=1.0, seed=0)
        with pytest.raises(pkg.sensor.InjectedFault):
            t.maybe_fail("here")
        t2 = pkg.sensor.FtTester(fail_prob=0.0, seed=0)
        for _ in range(100):
            t2.maybe_fail()
        assert t2.injected == 0

    def test_resource_usage(self, pkg):
        ru = pkg.sensor.resource_usage()
        assert ru["rss"] > 0 and ru["vmsize"] >= ru["rss"]


class TestErrMgr:
    """``tests/test_io_ft.py``'s TestErrMgr, the port held to the JAX
    package's final state."""

    def test_handler_registry(self, pkg):
        em = pkg.errmgr.ErrMgr()
        seen = []
        em.register(ValueError, lambda e: seen.append(repr(e)))
        assert em.handle(ValueError("x"))
        assert not em.handle(KeyError("y"))
        assert len(seen) == 1

    def test_run_with_restart_recovers_like_jax(self, worlds, tmp_path):
        from ompi_release_tpu.ft import Checkpointer as JCk
        from ompi_release_tpu_torch.ft import Checkpointer as TCk

        out = {}
        for k, ck_cls in (("jax", JCk), ("torch", TCk)):
            p = PKGS[k]
            ck = ck_cls(str(tmp_path / k), comm=worlds[k])
            fail_at = {13, 27}

            def step_fn(step, state, _fail=fail_at, _p=p):
                if step in _fail:
                    _fail.discard(step)
                    raise _p.sensor.InjectedFault(f"boom@{step}")
                return {"acc": state["acc"] + np.float32(step)}

            final, stats = p.errmgr.run_with_restart(
                step_fn, {"acc": np.float32(0.0)}, num_steps=30,
                checkpointer=ck, checkpoint_every=5)
            out[k] = (float(np.asarray(final["acc"])), stats["restarts"],
                      [s for s, _ in stats["failures"]])
        assert out["jax"] == out["torch"] == (
            float(sum(range(30))), 2, [13, 27])

    def test_run_with_restart_gives_up(self, pkg, worlds, tmp_path):
        from ompi_release_tpu.ft import Checkpointer as JCk
        from ompi_release_tpu_torch.ft import Checkpointer as TCk

        ck_cls = JCk if pkg.name == "jax" else TCk
        ck = ck_cls(str(tmp_path / "b"), comm=worlds[pkg.name])

        def always_fail(step, state):
            raise pkg.sensor.InjectedFault("always")

        with pytest.raises(pkg.sensor.InjectedFault):
            pkg.errmgr.run_with_restart(
                always_fail, {"x": np.float32(0)}, num_steps=5,
                checkpointer=ck, checkpoint_every=1, max_restarts=2)


# ---------------------------------------------------------------------------
# the HNP's heartbeat promotion and agreements
# ---------------------------------------------------------------------------

def _pair(coord, n_workers=1):
    hnp = coord.HnpCoordinator(n_workers + 1)
    agents = []

    def mk(nid):
        a = coord.WorkerAgent(nid, "127.0.0.1", hnp.port)
        a.run_modex({"node_id": nid})
        agents.append(a)

    threads = [threading.Thread(target=mk, args=(nid,))
               for nid in range(1, n_workers + 1)]
    for t in threads:
        t.start()
    hnp.run_modex(None)
    for t in threads:
        t.join(10)
    agents.sort(key=lambda a: a.node_id)
    return hnp, agents


class TestHeartbeatMonitor:
    def test_miss_limit_promotes_once(self, pkg, ft_states):
        hnp, (w1, w2) = _pair(pkg.coord, 2)
        try:
            fired, notices = [], []
            w1.start_ft_watcher(lambda d: notices.append(d))
            hnp.start_heartbeat_monitor(fired.append,
                                        interval_s=0.1, miss_limit=2)
            deadline = time.monotonic() + 5
            while not fired and time.monotonic() < deadline:
                w1.heartbeat()  # only w1 beats; w2 goes silent
                time.sleep(0.05)
            end = time.monotonic() + 0.5
            while time.monotonic() < end:
                w1.heartbeat()
                time.sleep(0.05)
            assert fired == [2]
            doc = hnp._ft_doc()
            assert doc["epoch"] >= 1 and doc["failed"] == [1]
            assert doc["failed_at"] == {"1": 1}
            assert any(n.get("failed") == [1] for n in notices)
        finally:
            hnp.shutdown()
            for a in (w1, w2):
                a.close()

    def test_recovered_in_time_beat_does_not_fire(self, pkg):
        hnp, (w,) = _pair(pkg.coord, 1)
        try:
            fired = []
            hnp.start_heartbeat_monitor(fired.append,
                                        interval_s=0.1, miss_limit=3)
            end = time.monotonic() + 1.2
            while time.monotonic() < end:
                w.heartbeat()
                time.sleep(0.1)
            assert fired == [] and hnp._ft_doc()["failed"] == []
        finally:
            hnp.shutdown()
            w.close()

    def test_failure_callback_orders_with_errmgr_handle(self, pkg):
        hnp, (w1, w2) = _pair(pkg.coord, 2)
        try:
            order = []
            mgr = pkg.errmgr.ErrMgr()
            mgr.register(pkg.Err,
                         lambda e: order.append(("handler", e.code.name)))

            def on_failure(nid):
                order.append(("cb", nid, tuple(hnp._ft_doc()["failed"])))
                claimed = mgr.handle(pkg.Err(
                    pkg.Code.ERR_PROC_FAILED, f"worker {nid}"))
                order.append(("handled", claimed))

            hnp.start_heartbeat_monitor(on_failure,
                                        interval_s=0.1, miss_limit=2)
            deadline = time.monotonic() + 5
            while len(order) < 3 and time.monotonic() < deadline:
                w1.heartbeat()
                time.sleep(0.05)
            assert order[:3] == [("cb", 2, (1,)),
                                 ("handler", "ERR_PROC_FAILED"),
                                 ("handled", True)]
        finally:
            hnp.shutdown()
            for a in (w1, w2):
                a.close()

    def test_restart_grace_excuses_cold_startup_silence(self, pkg):
        hnp, (w,) = _pair(pkg.coord, 1)
        try:
            fired = []
            hnp.start_heartbeat_monitor(fired.append,
                                        interval_s=0.05, miss_limit=2)
            time.sleep(0.3)
            assert fired == [1]
            hnp.note_restarted(1)
            time.sleep(0.5)  # 5x the window, inside the grace
            assert fired == [1], "replacement re-promoted during boot"
            w.heartbeat()  # the first beat ends the grace
            time.sleep(0.2)
            with hnp._hb_lock:
                assert 1 not in hnp._hb_restart_grace
            time.sleep(0.4)
            assert fired == [1, 1]
        finally:
            hnp.shutdown()
            w.close()

    def test_promote_failed_idempotent_and_skips_finished(self, pkg):
        hnp, (w,) = _pair(pkg.coord, 1)
        try:
            hnp.start_ft_responder()
            assert hnp.promote_failed(1) is True
            assert hnp.promote_failed(1) is False
            assert w.ft_query()["failed"] == [0]
            hnp.note_restarted(1)
            doc = w.ft_query()
            assert doc["failed"] == [] and doc["restarted"] == [0]
            assert doc["failed_at"] == {"0": 1} and doc["epoch"] == 2
            hnp.note_finished(1)
            assert hnp.promote_failed(1) is False
        finally:
            hnp.shutdown()
            w.close()

    def test_ft_agreement_excuses_failed_and_ands_flags(self, pkg):
        hnp, (w1, w2, w3) = _pair(pkg.coord, 3)
        try:
            hnp.start_ft_responder()
            hnp.promote_failed(2)  # pidx 1 is dead
            out = {}

            def contribute(agent, flag):
                out[agent.node_id] = agent.ft_agree(
                    5, 1, flag, [0, 1, 2], timeout_ms=10_000)

            ts = [threading.Thread(target=contribute, args=(w1, 1)),
                  threading.Thread(target=contribute, args=(w3, 0))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(10)
            assert not any(t.is_alive() for t in ts)
            for nid in (1, 3):
                assert out[nid]["flag"] == 0 and out[nid]["failed"] == [1]
            assert out[1]["epoch"] == out[3]["epoch"]
        finally:
            hnp.shutdown()
            for a in (w1, w2, w3):
                a.close()


# ---------------------------------------------------------------------------
# errmgr: respawn readiness
# ---------------------------------------------------------------------------

RESPAWN_DOCS = [
    None, {"epoch": 0},
    {"epoch": 3, "failed": [], "restarted": [2], "rejoined": [2]},
    {"epoch": 4, "failed": [1], "restarted": [2], "rejoined": [2]},
    {"epoch": 5, "failed": [], "restarted": [1, 2], "rejoined": [2]},
    {"epoch": 6, "failed": [], "restarted": [1, 2], "rejoined": [1, 2]},
    {"epoch": 2, "failed": [], "restarted": [], "rejoined": []},
]


class TestRespawnReadiness:
    def test_stale_cumulative_rejoined_not_ready(self):
        got = [terrmgr.respawn_ready(d) for d in RESPAWN_DOCS]
        assert got == [jerrmgr.respawn_ready(d) for d in RESPAWN_DOCS]
        assert got == [False, False, True, False, False, True, False]

    def test_recover_outside_tpurun(self, worlds, pkg):
        """shrink of a comm with no failure domain is a dup; respawn
        needs a recovery-enabled tpurun job."""
        w = worlds[pkg.name]
        c = pkg.errmgr.recover(w, "shrink")
        assert c.size == w.size and c.cid != w.cid
        c.free()
        assert _code(lambda: pkg.errmgr.recover(w, "respawn")) \
            == "ERR_NOT_AVAILABLE"
        assert _code(lambda: pkg.errmgr.recover(w, "bogus")) == "ERR_ARG"


# ---------------------------------------------------------------------------
# dpm: FT-aware rendezvous + lookup
# ---------------------------------------------------------------------------

def _dpm_mods(name):
    if name == "jax":
        from ompi_release_tpu.comm import dpm
        from ompi_release_tpu.comm.communicator import Communicator
        from ompi_release_tpu.comm.group import Group
    else:
        from ompi_release_tpu_torch.comm import dpm
        from ompi_release_tpu_torch.comm.communicator import Communicator
        from ompi_release_tpu_torch.comm.group import Group
    return dpm, Communicator, Group


class TestDpmFt:
    def test_connect_to_revoked_acceptor_fast_fails(self, pkg, worlds,
                                                    ft_states):
        dpm, Communicator, Group = _dpm_mods(pkg.name)
        world = worlds[pkg.name]
        a = Communicator(world.runtime, Group([0, 1]), name="dpm-a")
        b = Communicator(world.runtime, Group([2, 3]), name="dpm-b")
        port = dpm.open_port()
        errs = {}

        def accept():
            try:
                dpm.comm_accept(a, port, timeout_s=15)
            except pkg.Err as e:
                errs["accept"] = e

        t = threading.Thread(target=accept, daemon=True)
        t.start()
        time.sleep(0.3)  # acceptor parked
        a._revoked = True
        t0 = time.monotonic()
        with pytest.raises(pkg.Err) as ei:
            dpm.comm_connect(b, port, timeout_s=15)
        assert time.monotonic() - t0 < 5
        assert ei.value.code == pkg.Code.ERR_REVOKED
        t.join(5)
        dpm.close_port(port)
        a._revoked = False
        a.free()
        b.free()

    def test_accept_rejects_stale_epoch_joiner(self, pkg, worlds,
                                               ft_states):
        dpm, Communicator, Group = _dpm_mods(pkg.name)
        ft_states[pkg.name].apply_notice({"epoch": 4, "failed": []})
        port = dpm.open_port()  # opened at epoch 4
        b = Communicator(worlds[pkg.name].runtime, Group([2, 3]),
                         name="dpm-c")
        assert b._ft_epoch0 == 4
        with pytest.raises(pkg.Err) as ei:
            dpm.comm_connect(b, port, timeout_s=5, epoch=2)
        assert ei.value.code == pkg.Code.ERR_REVOKED
        assert "stale" in str(ei.value)
        dpm.close_port(port)
        b.free()

    def test_counterpart_of_failed_process_fast_fails(self, worlds,
                                                      ft_states):
        """The port's ``_check_counterpart`` sees the failed-process
        picture as the JAX package's does."""
        out = {}
        for k in PKGS:
            dpm, Communicator, Group = _dpm_mods(k)
            c = Communicator(worlds[k].runtime, Group([0, 1]),
                             name="dpm-f")
            ft_states[k].apply_notice({"epoch": 1, "failed": [0]})
            out[k] = _code(lambda: dpm._check_counterpart(
                c, "tpu-port:x", "connect"))
            ft_states[k].reset()
            c.free()
        assert out["jax"] == out["torch"] == "ERR_PROC_FAILED"

    def test_lookup_of_closed_port_raises_proc_failed(self, pkg, worlds,
                                                      ft_states):
        dpm, _c, _g = _dpm_mods(pkg.name)
        port = dpm.open_port()
        dpm.publish_name("dead-svc-ft", port)
        dpm.close_port(port)
        t0 = time.monotonic()
        with pytest.raises(pkg.Err) as ei:
            dpm.lookup_name("dead-svc-ft", timeout_s=10)
        assert ei.value.code == pkg.Code.ERR_PROC_FAILED
        assert time.monotonic() - t0 < 5
        dpm.unpublish_name("dead-svc-ft")


# ---------------------------------------------------------------------------
# tpurun plumbing
# ---------------------------------------------------------------------------

class TestTpurunFtFlags:
    def test_ft_env_matches_jax(self):
        """The contract env of every child, first incarnation and
        respawned, under each policy, is the JAX package's."""
        for kw in ({"ft_inject": (1, 7)},
                   {"on_failure": "restart", "ft_inject": (2, 0)},
                   {"on_failure": "continue"}):
            envs = {}
            for k, p in PKGS.items():
                job = p.tpurun.Job(3, ["true"], [], **kw)
                job.hnp = type("H", (), {"port": 1})()
                job.hnp_host = "127.0.0.1"
                e = {n: job._ompitpu_env(n) for n in (1, 2, 3)}
                job._restarts[2] = 1
                e["respawned"] = job._ompitpu_env(2)
                for d in e.values():
                    d.pop("OMPITPU_JOB_SECRET", None)
                envs[k] = e
            assert envs["jax"] == envs["torch"], kw
        t = envs["torch"]
        assert "OMPITPU_RECOVERY" not in t[1]
        assert t["respawned"]["OMPITPU_INCARNATION"] == "1"

    def test_ft_inject_arms_only_chosen_child_first_incarnation(self):
        job = ttpurun.Job(3, ["true"], [], ft_inject=(1, 7))
        job.hnp = type("H", (), {"port": 1})()
        job.hnp_host = "127.0.0.1"
        envs = {n: job._ompitpu_env(n) for n in (1, 2, 3)}
        key = "OMPITPU_MCA_sensor_ft_kill_step"
        assert envs[2][key] == "7"
        assert key not in envs[1] and key not in envs[3]
        job._restarts[2] = 1
        assert key not in job._ompitpu_env(2)

    def test_ft_inject_and_policy_validation(self, pkg):
        for kw in ({"ft_inject": (5, 0)}, {"ft_inject": (0, -1)},
                   {"on_failure": "bogus"}):
            with pytest.raises(pkg.Err):
                pkg.tpurun.Job(2, ["true"], [], **kw)
        assert pkg.tpurun.Job(2, ["true"], [],
                              on_failure="continue").on_failure \
            == "continue"

    def test_cli_parses_ft_flags(self, pkg, capsys):
        with pytest.raises(SystemExit):
            pkg.tpurun.main(["--help"])
        out = capsys.readouterr().out
        for flag in ("--ft-inject", "--ft-continue", "--enable-recovery",
                     "--max-restarts"):
            assert flag in out
        for argv in (["-n", "2", "--ft-inject", "bogus", "true"],
                     ["-n", "2", "--enable-recovery", "--ft-continue",
                      "true"]):
            with pytest.raises(SystemExit) as ei:
                pkg.tpurun.main(argv)
            assert ei.value.code == 2

    def test_continue_policy_aborts_on_bringup_failure(self, pkg):
        from ompi_release_tpu_torch.runtime.state import (
            JobState, ProcState,
        )

        job = pkg.tpurun.Job(2, ["true"], [], on_failure="continue")
        job.hnp = pkg.coord.HnpCoordinator(3)
        job.job_state.activate(JobState.INIT)
        job.job_state.activate(JobState.LAUNCH_DAEMONS)  # NOT running
        try:
            job._on_worker_failure(1, ProcState.ABORTED)
            assert job._failed.is_set()
            assert not job._ft_failed_ranks
        finally:
            job.hnp.shutdown()

    def test_migrate_refused_without_recovery(self, pkg):
        job = pkg.tpurun.Job(2, ["true"], [])
        reply = job.migrate_off({"off": "localhost"})
        assert not reply["ok"] and "--enable-recovery" in reply["error"]
        assert job.migrate_off({})["error"] == "missing 'off' host"

    def test_contact_file_discovery(self, tmp_path, monkeypatch):
        """tpurun's session contact file is what ``tpu-migrate`` finds
        the job by; a dead launcher's file is removed."""
        import json

        from ompi_release_tpu_torch.tools import tpu_migrate

        monkeypatch.setattr(ttpurun, "SESSION_DIR", str(tmp_path))
        job = ttpurun.Job(2, ["true"], [])
        job.hnp = type("H", (), {"port": 4321})()
        job._write_contact_file()
        (tmp_path / "999999999.json").write_text(json.dumps(
            {"pid": 999999999, "host": "x", "port": 1}))
        (tmp_path / "bool.json").write_text(json.dumps({"pid": True}))
        jobs = tpu_migrate.discover_jobs()
        assert [(j["pid"], j["port"], j["n"]) for j in jobs] == [
            (os.getpid(), 4321, 2)]
        assert sorted(os.listdir(tmp_path)) == [f"{os.getpid()}.json"]
        assert oct(os.stat(tmp_path / f"{os.getpid()}.json").st_mode
                   & 0o777) == "0o600"
        job._remove_contact_file()
        assert tpu_migrate.discover_jobs() == []
        assert tpu_migrate.main(["--off", "nodeB"]) == 1


# ---------------------------------------------------------------------------
# ElasticStep in-process: injected-fault rollback (no job needed)
# ---------------------------------------------------------------------------

def _elastic(name):
    if name == "jax":
        from ompi_release_tpu.ft.checkpoint import Checkpointer
        from ompi_release_tpu.parallel.elastic import ElasticStep
    else:
        from ompi_release_tpu_torch.ft.checkpoint import Checkpointer
        from ompi_release_tpu_torch.parallel.elastic import ElasticStep
    return Checkpointer, ElasticStep


class TestElasticStepLocal:
    def test_injected_fault_rolls_back_like_jax(self, worlds, tmp_path):
        out = {}
        for k, p in PKGS.items():
            Checkpointer, ElasticStep = _elastic(k)
            ck = Checkpointer(str(tmp_path / f"ck-{k}"))
            calls = []

            def step_fn(step, state, comm, _calls=calls):
                _calls.append(step)
                return np.asarray(state) + np.float32(step + 1)

            es = ElasticStep(worlds[k], step_fn, ck, policy="shrink",
                             checkpoint_every=1,
                             tester=p.sensor.FtTester(fail_prob=0.0,
                                                      every_n=4))
            state, stats = es.run(np.zeros((), np.float32), 6)
            out[k] = (float(np.asarray(state)), calls,
                      stats["injected_rollbacks"], stats["steps_lost"])
        assert out["jax"] == out["torch"]
        assert out["torch"][0] == float(sum(range(1, 7)))
        assert out["torch"][2] >= 1 and out["torch"][3] == 0

    def test_unseeded_probabilistic_injection_refused_spanning(
            self, pkg, worlds, tmp_path):
        Checkpointer, ElasticStep = _elastic(pkg.name)
        fake = type("C", (), {"spans_processes": True,
                              "runtime": worlds[pkg.name].runtime})()
        with pytest.raises(pkg.Err) as ei:
            ElasticStep(fake, lambda s, st, c: st,
                        Checkpointer(str(tmp_path / "r")),
                        tester=pkg.sensor.FtTester(fail_prob=0.1))
        assert "sensor_ft_seed" in str(ei.value)
        ElasticStep(fake, lambda s, st, c: st,
                    Checkpointer(str(tmp_path / "r")),
                    tester=pkg.sensor.FtTester(fail_prob=0.1, seed=42))

    def test_unconfirmed_suspect_error_reraises(self, pkg, worlds,
                                                tmp_path, ft_states):
        Checkpointer, ElasticStep = _elastic(pkg.name)

        def step_fn(step, state, comm):
            raise pkg.Err(pkg.Code.ERR_TRUNCATE, "flaky transfer")

        es = ElasticStep(worlds[pkg.name], step_fn,
                         Checkpointer(str(tmp_path / "ck2")),
                         confirm_timeout_s=0.3)
        with pytest.raises(pkg.Err) as ei:
            es.run(np.zeros((), np.float32), 2)
        assert ei.value.code == pkg.Code.ERR_TRUNCATE

    def test_policy_validated(self, pkg, worlds, tmp_path):
        Checkpointer, ElasticStep = _elastic(pkg.name)
        with pytest.raises(pkg.Err):
            ElasticStep(worlds[pkg.name], lambda s, st, c: st,
                        Checkpointer(str(tmp_path / "p")),
                        policy="bogus")


# ---------------------------------------------------------------------------
# vprotocol: the pessimist log (``tests/test_p2p.py:314-360``)
# ---------------------------------------------------------------------------

def _as_np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class TestVprotocolPessimist:
    def test_consumer_restart_replays_wildcard_order(self, worlds):
        """Both packages: the original run's wildcard deliveries and the
        restarted consumer's replayed deliveries, bitwise equal to each
        other and to the JAX package's."""
        out = {}
        for k, p in PKGS.items():
            world = worlds[k]
            sub = world.create(world.group.incl([0, 1, 2, 3]), name="vp")
            log = p.vprotocol.attach(sub)
            for rnd in range(2):
                for src in (1, 2, 3):
                    data = np.full(4, 10 * src + rnd, np.float32)
                    sub.isend(data, dest=0, tag=5, rank=src)
            original, dets = [], []
            for _ in range(6):
                v, st = sub.recv(source=-1, tag=5, rank=0)
                original.append(_as_np(v))
                dets.append(st.source)
            assert len(log.events) == 12
            p.vprotocol.detach(sub)
            fresh = sub.dup(name="vp_restarted")
            redelivered = [_as_np(v) for v in log.replay(fresh.pml)]
            assert len(redelivered) == 6
            for a, b in zip(original, redelivered):
                np.testing.assert_array_equal(a, b)
            out[k] = (np.stack(original), dets)
            fresh.free()
            sub.free()
        assert out["jax"][1] == out["torch"][1]
        assert out["jax"][0].tobytes() == out["torch"][0].tobytes()

    def test_log_keeps_its_own_payload_copy(self, worlds):
        """The sender-based log holds what was sent, not the sender's
        tensor: a write after the send does not reach the replay."""
        world = worlds["torch"]
        sub = world.create(world.group.incl([0, 1]), name="vp-copy")
        log = tvprotocol.attach(sub)
        buf = torch.full((4,), 3.0)
        sub.isend(buf, dest=0, tag=1, rank=1)
        v, _ = sub.recv(source=1, tag=1, rank=0)
        buf.fill_(-1.0)
        tvprotocol.detach(sub)
        fresh = sub.dup(name="vp-copy-restart")
        (again,) = log.replay(fresh.pml)
        assert torch.equal(again, torch.full((4,), 3.0))
        fresh.free()
        sub.free()

    def test_improbe_is_logged_as_a_determinant(self, worlds):
        world = worlds["torch"]
        sub = world.create(world.group.incl([0, 1, 2]), name="vp-mp")
        log = tvprotocol.attach(sub)
        sub.isend(np.float32([7.0]), dest=0, tag=3, rank=2)
        msg = sub.improbe(source=-1, tag=3, rank=0)
        v, st = sub.mrecv(msg, rank=0)
        ev = log.events[-1]
        assert (ev.matched_src, ev.matched_tag) == (2, 3)
        tvprotocol.detach(sub)
        sub.free()

    def test_replay_without_determinant_raises(self, pkg, worlds):
        world = worlds[pkg.name]
        sub = world.create(world.group.incl([0, 1]), name="vp2")
        log = pkg.vprotocol.attach(sub)
        sub.irecv(source=-1, tag=9, rank=0)  # never completes
        fresh = sub.dup(name="vp2_restart")
        with pytest.raises(pkg.Err):
            log.replay(fresh.pml)
        pkg.vprotocol.detach(sub)
