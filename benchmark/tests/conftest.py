"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q``.

They run the harness on the CPU at tiny sizes (the command line never
does: it needs a card). Tests marked ``cuda`` need an NVIDIA card and
skip without one.

Each cell's tiny stand-in sizes are ``tiny/<workload>.json`` (keys
``config`` and ``traffic``, merged over the cell's files), and each
per-layer metric's case on the synthetic profiler table is
``metric_cases/<metric>.json``: a cell or a metric added as files
brings its own."""

import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def _load_dir(path: Path) -> dict:
    return {p.name[:-len(".json")]: json.loads(p.read_text())
            for p in sorted(path.glob("*.json"))}


#: tiny stand-ins for the cells' sizes, by workload name
TINY = _load_dir(HERE / "tiny")
#: per-layer metric cases, by metric name
METRIC_CASES = _load_dir(HERE / "metric_cases")


def cells() -> list:
    """The names of ``BENCHMARK.json``'s workloads."""
    import harness

    return [w["name"] for w in harness.load_benchmark()["workloads"]]


def kind_of(workload: str) -> str:
    """``"step"`` for a train-step cell, else ``"collective"``."""
    import harness

    _, _, mix = harness.find_cell(harness.load_benchmark(), workload)
    return "step" if "step" in mix else "collective"


def collective_cells() -> list:
    return [w for w in cells() if kind_of(w) == "collective"]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def fresh_world():
    """The port's runtime torn down after the test, so the next run can
    bring WORLD up again."""
    yield
    from ompi_release_tpu_torch.runtime import runtime

    runtime._reset_for_tests()


@pytest.fixture
def run_cpu(fresh_world):
    """One harness run of a cell on the CPU at its tiny size."""
    import time

    import harness
    from ompi_release_tpu_torch.runtime import runtime

    def go(workload, seed=2**31 + 17, seconds=0.2, trace=False,
           program=None):
        try:
            return harness.run(workload, seed, seconds, trace,
                               t_start=time.perf_counter(), device="cpu",
                               overrides=TINY[workload], program=program)
        finally:
            runtime._reset_for_tests()

    return go
