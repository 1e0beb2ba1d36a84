"""The port's ``testing/`` (lockstep, fleet simulator, scenarios),
``tuning/retune.py`` and bench's simulator suites held against the JAX
package's.

The simulator is device-free and deterministic in both packages: the
same seed gives the same event log and the same result fields, value for
value. Every ``scenarios`` function runs at P = 256 for three seeds; the
port's ``fleet`` and ``multi_tenant`` bench lines equal bench.py's; the
online re-tuner triggers on the same samples of one stream and
``fleet_probe`` writes the same rule text.
"""

import json
import os

import numpy as np
import pytest

from ompi_release_tpu.coll import hier_schedules as jhs
from ompi_release_tpu.testing import fleet_sim as jfs
from ompi_release_tpu.testing import lockstep as jls
from ompi_release_tpu.testing import scenarios as jsc
from ompi_release_tpu.tuning import retune as jretune
from ompi_release_tpu.mca import var as jvar

from ompi_release_tpu_torch.coll import dynamic_rules as tdr
from ompi_release_tpu_torch.coll import hier_schedules as ths
from ompi_release_tpu_torch.mca import var as tvar
from ompi_release_tpu_torch.testing import fleet_sim as tfs
from ompi_release_tpu_torch.testing import lockstep as tls
from ompi_release_tpu_torch.testing import scenarios as tsc
from ompi_release_tpu_torch.tuning import retune as tretune

P = 256
SEEDS = (0, 1, 2)
_REPORT = ("participants", "rounds", "msgs_sent", "msgs_recvd",
           "bytes_sent", "inter_bytes_sent", "loss_retx", "makespan")


def _plain(v):
    """A comparable form of a result field: arrays to lists, errors to
    their text, reports and fleets to their metrology."""
    if isinstance(v, np.ndarray):
        return ("arr", str(v.dtype), v.tolist())
    if isinstance(v, BaseException):
        return ("exc", type(v).__name__, str(v))
    if isinstance(v, (jfs.RunReport, tfs.RunReport)):
        return {k: _plain(getattr(v, k)) for k in _REPORT} | {
            "outcomes": _plain(v.outcomes)}
    if isinstance(v, (jfs.FleetSim, tfs.FleetSim)):
        return v.event_log_json()
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def _fields(res):
    return {k: _plain(getattr(res, k)) for k in res.__slots__}


class TestScenarios:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_cascading_failure(self, seed):
        j = jsc.cascading_failure(P, seed=seed)
        t = tsc.cascading_failure(P, seed=seed)
        assert len(j.event_log_json) > 1000
        assert _fields(t) == _fields(j)

    @pytest.mark.parametrize("seed", SEEDS)
    def test_multi_tenant_with_a_bulk_kill(self, seed):
        j = jsc.multi_tenant(P, seed=seed, kill_bulk=True)
        t = tsc.multi_tenant(P, seed=seed, kill_bulk=True)
        assert j.killed_rank is not None
        assert _fields(t) == _fields(j)
        assert t.p99(t.qos_durations) == j.p99(j.qos_durations)

    @pytest.mark.parametrize("seed", SEEDS)
    def test_sentinel_desync(self, seed):
        j = jsc.sentinel_desync(P, seed=seed)
        t = tsc.sentinel_desync(P, seed=seed)
        assert t.event_log_json() == j.event_log_json()
        for p in (0, 137, 255):
            assert t.chain_of(p, 1) == j.chain_of(p, 1)

    def test_journals_dump_alike(self, tmp_path):
        j = jsc.sentinel_desync(32, divergent_rank=9, seed=4)
        t = tsc.sentinel_desync(32, divergent_rank=9, seed=4)
        j.write_journals(str(tmp_path / "j"))
        t.write_journals(str(tmp_path / "t"))
        names = sorted(os.listdir(tmp_path / "j"))
        assert names == sorted(os.listdir(tmp_path / "t")) and names
        for n in names:
            with open(tmp_path / "j" / n) as f:
                jd = json.load(f)
            with open(tmp_path / "t" / n) as f:
                td = json.load(f)
            assert td == jd


class TestFleetSim:
    def test_fabric_model_equals_jax(self):
        fabs = {}
        for name, mod in (("jax", jfs), ("torch", tfs)):
            f = mod.Fabric(16, hosts_per=4, seed=3)
            f.slow_nic(5, 10.0)
            f.bandwidth_share(2, 0.25)
            f.set_link(1, 9, mod.LinkSpec(3e-5, 5.0, loss=0.4))
            f.partition(range(0, 8), range(8, 16), 1e-3, 2e-3)
            fabs[name] = f
        t, j = fabs["torch"], fabs["jax"]
        for s in range(16):
            for d in range(16):
                assert t.link(s, d) == j.link(s, d)
                for t_send in (0.0, 1.5e-3, 5e-3):
                    for k in range(3):
                        assert t.delivery(s, d, 4096, t_send, k) \
                            == j.delivery(s, d, 4096, t_send, k)
        assert t.hosts() == j.hosts()

    @pytest.mark.parametrize("seed", SEEDS)
    def test_schedules_and_a_death_at_p256(self, seed):
        out = {}
        for name, fs, hs in (("jax", jfs, jhs), ("torch", tfs, ths)):
            fleet = fs.FleetSim(P, hosts_per=8, seed=seed)
            procs = fleet.procs
            data = {p: np.arange(2 * P, dtype=np.float32) * (p % 7 + 1)
                    for p in procs}
            r1 = fleet.run(lambda x, p: hs.allreduce_rabenseifner(
                x, procs, p, data[p], np.add, 0.0), label="allreduce")
            fleet.kill(17 + seed, at_round=3)
            val = np.arange(16, dtype=np.int32)
            r2 = fleet.run(lambda x, p: hs.bcast_binomial(
                x, procs, p, 0, val if p == 0 else None), cid=2,
                label="bcast")
            out[name] = (_plain(r1), _plain(r2), fleet.event_log_json(),
                         fleet.final_notice())
        assert out["torch"] == out["jax"]
        assert out["torch"][1]["outcomes"][17 + seed][0] != "ok"

    def test_lockstep_runs_the_schedules_alike(self):
        procs = list(range(6))
        data = {p: np.arange(12, dtype=np.float32) + p for p in procs}
        got = {}
        for name, ls, hs in (("jax", jls, jhs), ("torch", tls, ths)):
            res = ls.simulate(procs, lambda x, p: hs.allreduce_ring(
                x, procs, p, data[p], np.add, 0.0))
            got[name] = {p: np.asarray(v).tolist() for p, v in res.items()}
        assert got["torch"] == got["jax"]


@pytest.fixture()
def retune_vars():
    names = ("tune_online_window", "tune_online_sustain",
             "tune_online_cooldown_s", "tune_online_slow_factor")
    for var in (jvar, tvar):
        var.set_value("tune_online_window", 4)
        var.set_value("tune_online_sustain", 2)
        var.set_value("tune_online_cooldown_s", 5.0)
    yield
    for var in (jvar, tvar):
        for n in names:
            var.VARS.unset(n)


class TestRetune:
    def test_triggers_on_the_same_samples(self, retune_vars):
        rng = np.random.RandomState(0)
        stream = []
        for k in range(120):
            cid = int(rng.randint(0, 3))
            slow = 30 <= k < 45 or 80 <= k < 90
            stream.append((cid, float(rng.uniform(8, 12) if slow
                                      else rng.uniform(100, 140))))
        trig = {}
        for name, mod in (("jax", jretune), ("torch", tretune)):
            clk = [0.0]
            rt = mod.OnlineRetuner(clock=lambda: clk[0])
            hits = []
            for k, (cid, mb_s) in enumerate(stream):
                clk[0] = k * 0.25
                if rt.observe_rate(cid, mb_s):
                    hits.append(k)
                    rt._last_apply[cid] = clk[0]  # a probe applied
            # the sampler's point shape folds to the same samples
            pts = [{"t": k, "cid": cid, "name": n, "v": v}
                   for k, (cid, mb_s) in enumerate(stream)
                   for n, v in (("coll_bytes", mb_s * 1e6),
                                ("coll_seconds", 1.0))]
            rt2 = mod.OnlineRetuner(clock=lambda: 0.0)
            trig[name] = (hits, rt2.observe_points(pts))
        assert trig["torch"] == trig["jax"]
        assert trig["torch"][0]

    @pytest.mark.parametrize("straggler", [False, True])
    def test_fleet_probe_writes_the_same_rule(self, straggler, tmp_path):
        texts = {}
        for name, mod, fs in (("jax", jretune, jfs),
                              ("torch", tretune, tfs)):
            def fabric():
                f = fs.Fabric(32, hosts_per=8, seed=3)
                f.slow_nic(5, 10.0)
                return f

            texts[name] = mod.fleet_probe(
                32, 8, n_elems=512, seed=3,
                fabric_factory=fabric if straggler else None)
        assert texts["torch"] == texts["jax"]
        path = tmp_path / "probe.conf"
        path.write_text(texts["torch"])
        rules = tdr.load_rules(str(path))
        assert rules["hier_allreduce"][0][2] in ("ring", "multiring",
                                                 "torus2d")


class TestBenchSimSuites:
    def test_fleet_lines_equal_bench_py(self):
        import bench
        from ompi_release_tpu_torch import bench as tbench

        assert tbench.fleet_suite((64,)) == bench._fleet_micro_suite(
            sizes=(64,))

    def test_multi_tenant_lines_equal_bench_py(self):
        import bench
        from ompi_release_tpu_torch import bench as tbench

        got = tbench.multi_tenant_suite((64,))
        assert got == bench._multi_tenant_micro_suite(sizes=(64,))
        by = {ln["metric"]: ln for ln in got}
        iso = by["tenant_latency_isolation_p64"]
        assert iso["value"] <= iso["bound"] * 1.10
        assert by["tenant_fifo_hol_ratio_p64"]["value"] > iso["value"]
