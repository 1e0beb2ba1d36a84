"""The port's ``tools/tpu_tune.py`` held against the JAX package's.

The emitters (``emit``, ``emit_hier_rules``, ``emit_tree_rules``,
``emit_wire_rules``) give the same text for the same measurements, the
decision units (``unit_bytes``) and ``measured_fingerprint`` are the
same, and a rule file the port emits loads through the port's
``dynamic_rules`` and steers its tuned allreduce. The sweeps run here
on the CPU (``device="cpu"``; on a card they run on ``cuda:0``): the
in-process measure -> emit -> load -> apply cycle on 8 virtual ranks,
the wire segsize sweep through a loopback endpoint pair, and the hier
and tree sweeps' loopback jobs.
"""

import numpy as np
import pytest
import torch

import ompi_release_tpu as jmpi
from ompi_release_tpu.tools import tpu_tune as jtune
from ompi_release_tpu.tuning import db as jdb

import ompi_release_tpu_torch as tmpi
from ompi_release_tpu_torch.coll import dynamic_rules as tdr
from ompi_release_tpu_torch.coll import hier_schedules  # noqa: F401  (registers the hier_* rule names)
from ompi_release_tpu_torch.mca import var as tvar
from ompi_release_tpu_torch.tools import tpu_tune as ttune
from ompi_release_tpu_torch.tuning import db as tdb

N = 8

RESULTS = {
    "allreduce": [
        {"size": 1024, "unit_bytes": 1024,
         "times": {"recursive_doubling": 7.4e-5, "ring": 2.4e-4,
                   "basic_linear": 9.8e-5},
         "compile": {"recursive_doubling": 0.0021, "ring": 0.004},
         "winner": "recursive_doubling"},
        {"size": 1 << 20, "unit_bytes": 1 << 20,
         "times": {"recursive_doubling": 1.08e-4, "ring": 3.29e-4},
         "compile": {}, "winner": "recursive_doubling",
         "segsize": 0, "segsize_times": {0: 1.1e-4, 262144: 2e-4}},
        {"size": 16 << 20, "unit_bytes": 16 << 20,
         "times": {"ring": 1.5e-3, "recursive_doubling": 1.09e-3},
         "compile": {"ring": 0.0}, "winner": "ring", "segsize": 262144,
         "segsize_times": {0: 1.7e-3, 262144: 1.5e-3}},
    ],
    "bcast": [
        {"size": 1024, "unit_bytes": 1024,
         "times": {"binomial": 7e-5, "chain": 9e-5}, "winner": "binomial"},
    ],
    "alltoall": [],
}
HIER = {"nprocs": 4, "hosts_per": 2, "results": {
    "allreduce": [
        {"size": 1024, "unit_bytes": 1024,
         "times": {"linear": 1e-3, "recursive_doubling": 5e-4},
         "winner": "recursive_doubling"},
        {"size": 1 << 20, "unit_bytes": 1 << 20,
         "times": {"ring": 1e-3, "recursive_doubling": 2e-3,
                   "torus2d": 1.5e-3}, "winner": "ring"},
        {"size": 4 << 20, "unit_bytes": 4 << 20,
         "times": {"ring": 4e-3, "torus2d": 3e-3}, "winner": "torus2d"},
    ],
    "bcast": [{"size": 1024, "unit_bytes": 1024,
               "times": {"binomial": 1e-4}, "winner": "binomial"}],
    "gather": []}}
TREES = [
    {"nprocs": 3, "tree_bytes": 2 << 20, "leaves": 24, "rows": [
        {"bucket": 0, "seconds": 0.012, "transfers": 24},
        {"bucket": 1 << 20, "seconds": 0.004, "transfers": 3},
        {"bucket": 4 << 20, "seconds": 0.005, "transfers": 1}]},
    {"nprocs": 2, "tree_bytes": 1 << 20, "leaves": 4, "rows": [
        {"bucket": 0, "seconds": 0.001, "transfers": 4},
        {"bucket": 1 << 20, "seconds": 0.002, "transfers": 1}]},
    {"nprocs": 2, "tree_bytes": 0, "leaves": 0, "rows": []},
]


@pytest.fixture(scope="module")
def worlds():
    return {"jax": jmpi.init(),
            "torch": tmpi.init(cli_args=["--mca", "runtime_virtual_ranks",
                                         str(N)], device="cpu")}


def _body(text):
    """The emitted text without its mesh line (the device differs)."""
    return [ln for ln in text.splitlines() if not ln.startswith("# mesh:")]


class TestEmitters:
    def test_emit_equals_jax(self, worlds):
        t = ttune.emit(worlds["torch"], RESULTS)
        j = jtune.emit(worlds["jax"], RESULTS)
        assert _body(t) == _body(j)
        assert "# mesh: 8 virtual ranks of cpu, comm size 8" in t
        assert "[differs from fixed constants" in t

    def test_hier_tree_and_wire_emitters_equal_jax(self):
        assert ttune.emit_hier_rules(HIER) == jtune.emit_hier_rules(HIER)
        assert ttune.emit_hier_rules({}) == jtune.emit_hier_rules({}) == ""
        for sweep in TREES:
            assert ttune.emit_tree_rules(sweep) \
                == jtune.emit_tree_rules(sweep)
        for seg in ({0: 0.2, 65536: 0.1, 1 << 20: 0.12}, {0: 0.1},
                    {}):
            assert ttune.emit_wire_rules(seg) == jtune.emit_wire_rules(seg)

    @pytest.mark.parametrize("op", sorted(jtune._OPS))
    def test_unit_bytes_equal_jax(self, op):
        for n in (1, 2, 3, 8, 64):
            for b in (0, 4, 1000, 1 << 20, (1 << 24) + 12):
                assert ttune.unit_bytes(op, b, n) == jtune._OPS[op][1](b, n)

    def test_measured_fingerprint_equals_jax(self):
        for procs, per in ((0, 0), (1, 0), (4, 0), (4, 2), (5, 2),
                           (8, 3), (16, 4)):
            t = ttune.measured_fingerprint(procs, per)
            j = jtune.measured_fingerprint(procs, per)
            assert t.canon() == j.canon()
        assert ttune.measured_fingerprint() == tdb.LOCAL
        assert tdb.LOCAL.canon() == jdb.LOCAL.canon()

    def test_emitted_files_load_in_the_port(self, worlds, tmp_path):
        text = (ttune.emit(worlds["torch"], RESULTS)
                + ttune.emit_hier_rules(HIER)
                + ttune.emit_tree_rules(TREES[0]))
        text = tdb.stamp(text, ttune.measured_fingerprint(4, 2))
        p = tmp_path / "rules.conf"
        p.write_text(text)
        rules = tdr.load_rules(str(p))
        # a row whose winner keeps its algorithm but gains a segsize
        # column starts a rule of its own
        assert [(r[1], r[2], r[3]) for r in rules["allreduce"]] == [
            (0, "recursive_doubling", None),
            (1 << 20, "recursive_doubling", 0),
            (16 << 20, "ring", 262144)]
        assert [r[2] for r in rules["hier_allreduce"]] \
            == ["recursive_doubling", "ring", "torus2d"]
        assert rules["tree_buckets"] == [(0, 0, "fused", 1 << 20)]


class TestSweepsOnTheCpu:
    def test_measure_emit_load_apply(self, worlds, tmp_path):
        world = worlds["torch"]
        results = ttune.measure(world, ["allreduce", "alltoall"],
                                [1024, 262144], repeats=2,
                                segsizes=[65536])
        assert results["allreduce"] and results["alltoall"]
        for rows in results.values():
            for row in rows:
                assert row["winner"] in row["times"]
                assert min(row["times"].values()) \
                    == row["times"][row["winner"]]
        p = tmp_path / "rules.conf"
        p.write_text(ttune.emit(world, results))
        assert tdr.load_rules(str(p)).get("allreduce")
        tvar.set_value("coll_tuned_use_dynamic_rules", True)
        tvar.set_value("coll_tuned_dynamic_rules_filename", str(p))
        try:
            first = results["allreduce"][0]
            assert tdr.lookup("allreduce", world.size,
                              first["unit_bytes"]) == first["winner"]
            x = np.ones((world.size, 64), np.float32)
            assert (world.allreduce(x).numpy() == world.size).all()
        finally:
            tvar.VARS.unset("coll_tuned_use_dynamic_rules")
            tvar.VARS.unset("coll_tuned_dynamic_rules_filename")
        # measure restores what it pinned
        assert not tvar.get("coll_tuned_use_dynamic_rules", False)

    def test_cli_writes_a_loadable_stamped_file(self, worlds, tmp_path,
                                                capsys):
        out = tmp_path / "cli.conf"
        rc = ttune.main(["-o", str(out), "--ops", "allreduce", "--sizes",
                         "1024,65536", "--repeats", "1", "--segsizes", "",
                         "--device", "cpu", "--ranks", str(N)])
        assert rc == 0
        assert "tpu-tune: wrote" in capsys.readouterr().out
        text = out.read_text()
        assert text.startswith("# fingerprint: ")
        assert tdr.load_rules(str(out))["allreduce"]

    def test_time_once_waits_for_the_card(self, monkeypatch):
        """Each timed call is closed by a synchronisation of the device
        the input lives on (a no-op on the host)."""
        calls = []
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda d=None: calls.append(d))
        x = torch.ones(4)
        ttune._time_once(lambda c, v: v + 1, None, x)
        assert calls == []
        x = torch.ones(4, device="meta")
        monkeypatch.setattr(ttune, "_sync", lambda d: calls.append(d))
        ttune._time_once(lambda c, v: v, None, x)
        assert calls == [x.device, x.device]

    def test_wire_segsize_sweep(self):
        got = ttune.sweep_wire_segsizes([65536, 1 << 20],
                                        size_bytes=4 << 20, repeats=1)
        assert set(got) == {0, 65536, 1 << 20}
        assert "wire_pipeline_segsize" in ttune.emit_wire_rules(got, 4 << 20)

    def test_hier_sweep_loopback_job(self, tmp_path):
        sweep = ttune.sweep_hier(2, ["allreduce"], [4096], repeats=1,
                                 timeout_s=240, device="cpu")
        assert sweep is not None and sweep["nprocs"] == 2
        rows = sweep["results"]["allreduce"]
        assert rows, sweep
        legal = set(tdr.RULE_COLLECTIVES["hier_allreduce"])
        for row in rows:
            assert row["winner"] in row["times"]
            assert set(row["times"]) <= legal
        p = tmp_path / "swept.conf"
        p.write_text(ttune.emit_hier_rules(sweep))
        assert tdr.load_rules(str(p))["hier_allreduce"]

    def test_tree_sweep_loopback_job(self, tmp_path):
        sweep = ttune.sweep_tree_buckets(2, [1 << 20], repeats=1,
                                         timeout_s=240, device="cpu")
        assert sweep is not None and sweep["nprocs"] == 2
        assert [r["bucket"] for r in sweep["rows"]] == [0, 1 << 20]
        assert sweep["rows"][0]["transfers"] == sweep["leaves"] == 24
        p = tmp_path / "tree.conf"
        p.write_text(ttune.emit_tree_rules(sweep))
        assert tdr.load_rules(str(p))["tree_buckets"]
