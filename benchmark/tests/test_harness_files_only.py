"""A train-step cell lands as new files only: the stand-in cell's
configuration, traffic, reference, tiny sizes, per-layer reader and its
case are added to a copy of the benchmark, its entries appended to
``BENCHMARK.json``, and the whole suite passes there with no file of
the benchmark touched: the cell's run, traced run and control among
every cell's."""

import json
import subprocess
import sys

import standin
from conftest import BENCH, ROOT


def _files(base):
    return {p.relative_to(base): p.read_bytes() for p in base.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts
            and ".pytest_cache" not in p.parts}


def test_a_new_step_cell_is_files_only(tmp_path):
    tree = standin.make_tree(tmp_path / "tree")
    before, after = _files(BENCH), _files(tree / "benchmark")
    assert all(after[p] == data for p, data in before.items())
    added = set(after) - set(before)
    assert {p.parts[0] for p in added} >= {"configs", "traffic", "reference",
                                           "metrics", "tests"}
    old = json.loads((ROOT / "BENCHMARK.json").read_text())
    new = json.loads((tree / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert new[key][:len(old[key])] == old[key]
    for name in ("tokens_per_s", "mfu"):
        listed = [m.get("workloads") for m in new["end_to_end"]
                  if m["name"] == name]
        assert listed == [[standin.WORKLOAD]], name
    assert [w["name"] for w in new["workloads"][len(old["workloads"]):]] \
        == [standin.WORKLOAD]

    res = subprocess.run(
        [sys.executable, "-m", "pytest", "benchmark/tests", "-q", "-rA",
         "-p", "no:cacheprovider", "-k", "not files_only"],
        cwd=tree, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    ran = [line for line in res.stdout.splitlines()
           if line.startswith("PASSED") and standin.WORKLOAD in line]
    assert any("test_cell_is_correct_on_the_cpu" in line for line in ran)
    assert any("test_traced_cell_is_correct_on_the_cpu" in line
               for line in ran)
    assert any("test_control_is_not_correct" in line for line in ran)
