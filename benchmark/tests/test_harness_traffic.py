"""The traffic generator: the same seed gives the same work, every seed
the same multiset of sizes."""

import generator
import harness
from conftest import TINY

CELLS = sorted(TINY)


def _built(workload, seed):
    bench = harness.load_benchmark()
    _, config, mix = harness.find_cell(bench, workload)
    return generator.build(mix, config, seed)


def test_every_cell_builds_from_its_files():
    bench = harness.load_benchmark()
    for cell in bench["workloads"]:
        t = _built(cell["name"], 7)
        assert t.units and t.ranks == 8 and t.dtype == "float32"


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
