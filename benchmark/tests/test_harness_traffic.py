"""The traffic generator: the same seed gives the same work, every seed
the same multiset of sizes, each kind of mix its own invariants, and
the collective mixes the work they gave before train steps came
(``golden_traffic.json``)."""

import json
import math

import generator
import harness
from conftest import HERE, collective_cells

CELLS = collective_cells()


def _built(workload, seed):
    bench = harness.load_benchmark()
    _, config, mix = harness.find_cell(bench, workload)
    return generator.build(mix, config, seed)


def test_every_cell_builds_from_its_files():
    bench = harness.load_benchmark()
    for cell in bench["workloads"]:
        _, config, mix = harness.find_cell(bench, cell["name"])
        t = _built(cell["name"], 7)
        if "step" in mix:
            model = config["model"]
            assert isinstance(t, generator.StepTraffic)
            assert t.tokens == mix["batch"] * mix["seq"] > 0
            assert t.vocab == model["config"]["vocab"]
            assert t.ranks == math.prod(model["mesh"].values())
            assert t.seq <= model["config"]["max_seq"]
        else:
            assert t.units and t.ranks == config.get(
                "ranks", config.get("workers"))
            assert t.dtype == config["dtype"]
            assert all(s[0] == t.ranks for u in t.units for s in u.shapes)


def test_the_collective_mixes_build_as_before():
    golden = json.loads((HERE / "golden_traffic.json").read_text())
    for key, want in golden.items():
        name, seed = key.split("@")
        t = _built(name, int(seed))
        got = {"collective": t.collective, "ranks": t.ranks,
               "dtype": t.dtype,
               "units": [[[list(s) for s in u.shapes], u.bytes_per_rank]
                         for u in t.units],
               "blocks": [t.block(i) for i in range(12)],
               "sample_start": [t.sample_start[i]
                                for i in range(len(t.units))],
               "sample_len": t.sample_len, "sample_span": t.sample_span,
               "trace_blocks": t.trace_blocks, "min_blocks": t.min_blocks()}
        assert got == want, key


def test_same_seed_same_blocks_and_samples():
    for w in CELLS:
        a, b = _built(w, 2**31 + 99), _built(w, 2**31 + 99)
        assert [a.block(i) for i in range(50)] == [b.block(i)
                                                  for i in range(50)]
        assert a.sample_start == b.sample_start


def test_seeds_change_the_order_not_the_mix():
    a, b = (_built("allreduce_mid.nccl_tests_8r", s) for s in (1, 2))
    blocks_a = [a.block(i) for i in range(40)]
    blocks_b = [b.block(i) for i in range(40)]
    assert blocks_a != blocks_b
    for blk in blocks_a + blocks_b:
        assert sorted(blk) == list(range(len(a.units)))


def test_large_seed_and_bert_list():
    t = _built("gradsync.bert_large_ddp_8r", 2**31 + 2**30)
    (unit,) = t.units
    assert len(unit.shapes) == 398
    assert unit.bytes_per_rank == 336226108 * 4
    # reverse creation order: the next-sentence bias comes first
    assert unit.shapes[0] == (8, 2) and unit.shapes[-1] == (8, 30522, 1024)


def test_samples_fall_inside_every_window():
    for w in CELLS:
        t = _built(w, 12345)
        for u in range(len(t.units)):
            kept = [o for o in range(t.min_blocks()) if t.kept(u, o)]
            assert len(kept) == t.sample_len
        assert t.trace_blocks >= t.min_blocks()
