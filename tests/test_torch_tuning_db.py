"""The tuning database and the fingerprint stanza of the PyTorch port
held against the JAX package (``tuning/db.py``,
``coll/dynamic_rules.py``).

The in-process cases of ``tests/test_topo_tuning.py`` (TestFingerprint,
TestHeaderStanzaInRules, TestTuningDb, TestDbAutoSelection) run through
both packages: the same canonical forms, parsed tables, entry names,
versions, nearest matches and lookups. The reference's cases name
``hier_*`` rules, which need the cross-process collectives the port
does not have yet; here the same cases use the in-process collectives'
rule names. A tuned allreduce then takes the database's algorithm.
"""

import os

import numpy as np
import pytest
import torch

import ompi_release_tpu.coll.components  # noqa: F401  (rule namespaces)
from ompi_release_tpu.coll import dynamic_rules as jrules
from ompi_release_tpu.mca import var as jvar
from ompi_release_tpu.tuning import db as jdb
import ompi_release_tpu_torch as tmpi
import ompi_release_tpu_torch.coll.components  # noqa: F401
from ompi_release_tpu_torch.coll import dynamic_rules as trules
from ompi_release_tpu_torch.mca import var as tvar
from ompi_release_tpu_torch.runtime import runtime as trt
from ompi_release_tpu_torch.tuning import db as tdb
from ompi_release_tpu_torch.utils.errors import MPIError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CVARS = ("coll_tuned_use_dynamic_rules", "coll_tuned_dynamic_rules_filename",
         "coll_tuning_db_dir", "coll_tuned_allreduce_algorithm", "coll",
         "coll_tuned_segment_size")


@pytest.fixture(autouse=True)
def _clean_tuning_state():
    from ompi_release_tpu.coll.base import COLL_FRAMEWORK as JFW
    from ompi_release_tpu_torch.coll.base import COLL_FRAMEWORK as TFW

    JFW.lookup("tuned").register_vars()
    TFW.lookup("tuned").register_vars()
    yield
    for v in CVARS:
        jvar.VARS.unset(v)
        tvar.VARS.unset(v)
    jdb._reset_for_tests()
    tdb._reset_for_tests()


def _set(**kv):
    for k, v in kv.items():
        jvar.set_value(k, v)
        tvar.set_value(k, v)


def _fps(hosts, ppn, links, P):
    return (jdb.Fingerprint(hosts, ppn, links, P),
            tdb.Fingerprint(hosts, ppn, links, P))


JA, TA = _fps(8, 8, ("shm", "dcn"), 64)
JB, TB = _fps(16, 8, ("shm", "dcn"), 128)
JL, TL = _fps(1, 4, ("shm",), 4)


class TestFingerprint:
    def test_canon_round_trip(self):
        assert TA.canon() == JA.canon() == "hosts=8;ppn=8;links=shm+dcn;P=64"
        assert TA.slug() == JA.slug()
        assert tdb.Fingerprint.parse(TA.canon()) == TA
        assert tdb.Fingerprint.parse(tdb.LOCAL.canon()) == tdb.LOCAL
        assert tdb.LOCAL.canon() == jdb.LOCAL.canon()

    def test_malformed_raises(self):
        for bad in ("hosts=8;ppn=8", "8/8/64", "",
                    "hosts=x;ppn=1;links=shm;P=4"):
            with pytest.raises(ValueError):
                tdb.Fingerprint.parse(bad)
            with pytest.raises(ValueError):
                jdb.Fingerprint.parse(bad)

    def test_fingerprint_for_layouts(self):
        for layout, P in (({0: "a", 1: "a", 2: "b", 3: "b"}, 4),
                          ({0: "a", 1: "a", 2: "b"}, 3),
                          ({0: "a", 1: "a"}, 2)):
            assert tdb.fingerprint_for(layout, P).canon() == \
                jdb.fingerprint_for(layout, P).canon()
        fp = tdb.fingerprint_for({0: "a", 1: "a", 2: "b"}, 3)
        assert fp.procs_per_host == 0 and fp.hosts == 2

    def test_stamp_and_read_header(self, tmp_path):
        text = tdb.stamp("allreduce  0  0  ring\n", TA, version=3)
        assert text == jdb.stamp("allreduce  0  0  ring\n", JA, version=3)
        p = tmp_path / "x.conf"
        p.write_text(text)
        got_fp, got_v = tdb.read_header(str(p))
        assert got_fp == TA and got_v == 3
        text2 = tdb.stamp(text, tdb.LOCAL, version=1)
        assert text2.count("# fingerprint:") == 1

    def test_legacy_file_reads_none(self, tmp_path):
        p = tmp_path / "legacy.conf"
        p.write_text("allreduce  0  0  ring\n")
        assert tdb.read_header(str(p)) == (None, None)
        p.write_text("# fingerprint: hosts=two\nallreduce 0 0 ring\n")
        with pytest.raises(MPIError):
            tdb.read_header(str(p))


class TestHeaderStanzaInRules:
    def test_stanza_is_parsed_not_skipped(self, tmp_path):
        p = tmp_path / "fp.conf"
        p.write_text("# fingerprint: hosts=2;ppn=4;links=shm+dcn;P=8\n"
                     "# version: 2\n"
                     "allreduce  0  0  segmented_ring\n")
        rules, meta = trules.load_rules_doc(str(p))
        assert (rules, meta) == jrules.load_rules_doc(str(p))
        assert meta["fingerprint"] == "hosts=2;ppn=4;links=shm+dcn;P=8"
        assert meta["version"] == 2
        assert rules["allreduce"] == [(0, 0, "segmented_ring", None)]

    def test_malformed_stanza_fails_at_load_with_lineno(self, tmp_path):
        p = tmp_path / "bad.conf"
        p.write_text("# fingerprint: hosts=two;ppn=1;links=shm;P=4\n"
                     "allreduce  0  0  ring\n")
        with pytest.raises(MPIError) as ei:
            trules.load_rules_doc(str(p))
        assert "bad.conf:1" in str(ei.value)

    def test_shipped_cpu8_rules_load_unchanged(self, tmp_path):
        """tuning/cpu8_rules.conf (no stanza) keeps the legacy
        semantics: the lines of the collectives the port has (its
        hier_* and tree_buckets lines name cross-process schedules the
        port lacks) parse to the same tables as in JAX, through both
        entry points, with no fingerprint."""
        src = os.path.join(REPO, "tuning", "cpu8_rules.conf")
        known = set(trules.RULE_COLLECTIVES)
        kept = [ln for ln in open(src).read().splitlines()
                if not ln.split() or ln.split()[0].startswith("#")
                or ln.split()[0] in known]
        p = tmp_path / "cpu8_in_process.conf"
        p.write_text("\n".join(kept) + "\n")
        rules, meta = trules.load_rules_doc(str(p))
        assert meta == {"fingerprint": None, "version": None}
        assert trules.load_rules(str(p)) == rules
        jfull = jrules.load_rules(src)
        assert rules == {k: v for k, v in jfull.items() if k in known}
        assert rules["allreduce"][0] == (0, 0, "nonoverlapping", None)
        assert (0, 65536, "segmented_ring", None) in rules["allreduce"]


class TestTuningDb:
    def _both_dbs(self, tmp_path):
        return (jdb.TuningDb(str(tmp_path / "j")),
                tdb.TuningDb(str(tmp_path / "t")))

    def test_register_versions_and_never_overwrites(self, tmp_path):
        jd, td = self._both_dbs(tmp_path)
        p1 = td.register("allreduce  0  0  ring\n", TA)
        p2 = td.register("allreduce  0  0  segmented_ring\n", TA)
        jd.register("allreduce  0  0  ring\n", JA)
        jp2 = jd.register("allreduce  0  0  segmented_ring\n", JA)
        assert os.path.basename(p2) == os.path.basename(jp2)
        assert p1 != p2 and os.path.exists(p1) and os.path.exists(p2)
        assert tdb.read_header(p1)[1] == 1
        assert tdb.read_header(p2)[1] == 2
        assert td.best_match(TA) == p2
        assert trules.load_rules(p2)["allreduce"] == \
            [(0, 0, "segmented_ring", None)]

    def test_register_validates_through_the_real_loader(self, tmp_path):
        td = tdb.TuningDb(str(tmp_path))
        with pytest.raises(MPIError):
            td.register("allreduce  0  0  no_such_alg\n", TA)
        assert os.listdir(tmp_path) == []  # nothing published, no temp

    def test_nearest_match_and_link_class_isolation(self, tmp_path):
        jd, td = self._both_dbs(tmp_path)
        pa = td.register("allreduce  0  0  segmented_ring\n", TA)
        td.register("allreduce  0  0  ring\n", TL)
        jd.register("allreduce  0  0  segmented_ring\n", JA)
        jd.register("allreduce  0  0  ring\n", JL)
        assert td.best_match(TB) == pa
        for (jfp, tfp) in ((JB, TB), _fps(1, 2, ("shm",), 2)):
            assert os.path.basename(td.best_match(tfp)) == \
                os.path.basename(jd.best_match(jfp))
        only = tdb.TuningDb(str(tmp_path / "sub"))
        only.register("allreduce  0  0  ring\n", TA)
        assert only.best_match(tdb.LOCAL) is None

    def test_select_cache_invalidated_by_register(self, tmp_path):
        tdb.set_active(TA)
        td = tdb.TuningDb(str(tmp_path))
        p1 = td.register("allreduce  0  0  ring\n", TA)
        assert tdb.select_rules_path(str(tmp_path), TA) == p1
        p2 = td.register("allreduce  0  0  segmented_ring\n", TA)
        assert tdb.select_rules_path(str(tmp_path), TA) == p2


class TestDbAutoSelection:
    def test_db_serves_rules_when_no_file_is_pointed(self, tmp_path):
        jdb.set_active(JA)
        tdb.set_active(TA)
        jdb.TuningDb(str(tmp_path / "j")).register(
            "allreduce  0  0  segmented_ring\n", JA)
        tdb.TuningDb(str(tmp_path / "t")).register(
            "allreduce  0  0  segmented_ring\n", TA)
        _set(coll_tuned_use_dynamic_rules=True)
        jvar.set_value("coll_tuning_db_dir", str(tmp_path / "j"))
        tvar.set_value("coll_tuning_db_dir", str(tmp_path / "t"))
        assert trules.lookup("allreduce", 64, 1 << 20) == \
            jrules.lookup("allreduce", 64, 1 << 20) == "segmented_ring"
        src = trules.rules_source()
        assert src["mode"] == "db" == jrules.rules_source()["mode"]
        assert src["fingerprint"] == TA.canon()

    def test_explicit_file_outranks_the_db(self, tmp_path):
        tdb.set_active(TA)
        tdb.TuningDb(str(tmp_path / "db")).register(
            "allreduce  0  0  segmented_ring\n", TA)
        pinned = tmp_path / "pinned.conf"
        pinned.write_text("allreduce  0  0  ring\n")
        tvar.set_value("coll_tuned_use_dynamic_rules", True)
        tvar.set_value("coll_tuning_db_dir", str(tmp_path / "db"))
        tvar.set_value("coll_tuned_dynamic_rules_filename", str(pinned))
        assert trules.lookup("allreduce", 64, 1 << 20) == "ring"
        assert trules.rules_source()["mode"] == "file"

    def test_no_matching_entry_falls_to_fixed_constants(self, tmp_path):
        tdb.set_active(TA)  # a spanning layout; the db holds LOCAL only
        tdb.TuningDb(str(tmp_path)).register("allreduce  0  0  ring\n", TL)
        tvar.set_value("coll_tuned_use_dynamic_rules", True)
        tvar.set_value("coll_tuning_db_dir", str(tmp_path))
        assert trules.lookup("allreduce", 64, 1 << 20) is None
        assert trules.rules_source()["mode"] == "off"

    def test_tuned_allreduce_takes_the_db_algorithm(self, tmp_path):
        """With dynamic rules on, no file named and the job's (local)
        fingerprint in the database, a tuned allreduce above 1 MiB
        takes the entry's ring where the fixed rules pick the segmented
        ring, with the same bits as ring forced."""
        tdb.TuningDb(str(tmp_path)).register(
            "allreduce  0  1048576  ring\n", tdb.active())
        trt._reset_for_tests()
        w = tmpi.init(cli_args=["--mca", "runtime_virtual_ranks", "8"],
                      device="cpu")
        try:
            tvar.set_value("coll", "tuned")
            c = w.dup(name="db_tuned")
            tvar.VARS.unset("coll")
            x = torch.from_numpy(np.random.default_rng(0).normal(
                size=(8, 600_000)).astype(np.float32))  # 2.4 MB per rank
            # 8 ranks x 64 KiB segments < 2.4 MB: fixed rules segment
            tvar.set_value("coll_tuned_segment_size", 65536)
            fixed = c.allreduce(x)
            assert any(k[:3] == ("tuned", "allreduce", "segmented_ring")
                       for k in c._coll_programs)
            tvar.set_value("coll_tuned_use_dynamic_rules", True)
            tvar.set_value("coll_tuning_db_dir", str(tmp_path))
            got = c.allreduce(x)
            assert any(k[:3] == ("tuned", "allreduce", "ring")
                       for k in c._coll_programs)
            tvar.VARS.unset("coll_tuned_use_dynamic_rules")
            tvar.set_value("coll_tuned_allreduce_algorithm", "ring")
            forced = c.allreduce(x)
            assert torch.equal(got.view(torch.int32),
                               forced.view(torch.int32))
            assert not torch.equal(got.view(torch.int32),
                                   fixed.view(torch.int32))
            c.free()
        finally:
            trt._reset_for_tests()
            tvar.VARS.unset("runtime_virtual_ranks")
