"""The stand-in train-step cell ``train_2k.tpulm_standin``: the port's
dense TpuLM on a dp x ep mesh of virtual ranks of one card. It sizes the
bounds of the train-step metrics and tests the train-step path; it is
never a cell of the benchmark (the TpuLM is no public family).

Its files lie under ``standin/`` in the benchmark's own layout
(``configs``, ``traffic``, ``reference``, ``metrics``, ``tiny``,
``metric_cases``), with ``cell.json``: the entries a later change that
adds such a cell appends to ``BENCHMARK.json``, the end-to-end metrics
``tokens_per_s`` and ``mfu`` among them, which no cell of the benchmark
reports yet. ``overlay`` lays them over a copy of the benchmark as new
files only;

    python3 benchmark/tests/standin.py DEST

makes DEST a checkout with the cell, from which it runs as any cell:
``python3 benchmark/run.py --workload train_2k.tpulm_standin ...``.
"""

import json
import os
import shutil
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
DATA = HERE / "standin"
BENCH = HERE.parent
ROOT = BENCH.parent
WORKLOAD = "train_2k.tpulm_standin"

#: where each of the stand-in's folders goes in the benchmark
PLACES = {"configs": "configs", "traffic": "traffic",
          "reference": "reference", "metrics": "metrics",
          "tiny": "tests/tiny", "metric_cases": "tests/metric_cases"}


def with_cell(bench: dict) -> dict:
    """``bench`` (BENCHMARK.json's contents) with the stand-in's entries
    appended, unless it has them already: an end-to-end metric that
    ``bench`` lacks comes in listing the stand-in's cell, and one that
    lists its cells gets the stand-in's appended."""
    cell = json.loads((DATA / "cell.json").read_text())
    bench = json.loads(json.dumps(bench))
    names = [w["name"] for w in cell["workloads"]]
    if names[0] in {w["name"] for w in bench["workloads"]}:
        return bench
    bench["configs"] += cell["configs"]
    bench["workloads"] += cell["workloads"]
    have = {m["name"]: m for m in bench["end_to_end"]}
    for m in cell["end_to_end"]:
        if m["name"] not in have:
            bench["end_to_end"].append(dict(m, workloads=names))
        elif "workloads" in have[m["name"]]:
            have[m["name"]]["workloads"] += names
    bench["per_layer"] += [dict(m, workloads=names)
                           for m in cell["per_layer"]]
    return bench


def overlay(bench_dir: Path, bench_json: Path) -> None:
    """The stand-in's files added under ``bench_dir`` (never over a file
    there) and its entries to ``bench_json``, unless it has them."""
    bench = json.loads(bench_json.read_text())
    if WORKLOAD in {w["name"] for w in bench["workloads"]}:
        return
    for sub, place in PLACES.items():
        for src in sorted((DATA / sub).iterdir()):
            dst = bench_dir / place / src.name
            if dst.exists():
                raise FileExistsError(dst)
            shutil.copy(src, dst)
    bench_json.write_text(json.dumps(with_cell(bench), indent=2) + "\n")


def make_tree(dest: Path) -> Path:
    """DEST as a checkout: ``BENCHMARK.json``, a copy of ``benchmark/``
    with the stand-in laid over it, and the port's package linked."""
    dest = Path(dest)
    shutil.copytree(BENCH, dest / "benchmark", ignore=shutil.ignore_patterns(
        "__pycache__", ".pytest_cache"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    os.symlink(ROOT / "ompi_release_tpu_torch",
               dest / "ompi_release_tpu_torch")
    overlay(dest / "benchmark", dest / "BENCHMARK.json")
    return dest


if __name__ == "__main__":
    print(make_tree(Path(sys.argv[1])))
