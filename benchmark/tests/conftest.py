"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q``.

They run the harness on the CPU at tiny sizes (the command line never
does: it needs a card). Tests marked ``cuda`` need an NVIDIA card and
skip without one."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: tiny stand-ins for the mixes' sizes and the BERT parameter list
TINY = {
    "allreduce_large.nccl_tests_8r": {
        "traffic": {"sizes_bytes_per_rank": [4096, 65536, 1 << 20]}},
    "allreduce_mid.nccl_tests_8r": {
        "traffic": {"sizes_bytes_per_rank": [1024, 8192, 65536]}},
    "alltoall_large.nccl_tests_8r": {
        "traffic": {"sizes_bytes_per_rank": [4096, 65536, 1 << 20]}},
    "gradsync.bert_large_ddp_8r": {
        "config": {"parameters": [["a", [64, 32]], ["b", [32]],
                                  ["c", [300, 128]], ["d", [7]],
                                  ["e", [128, 128]], ["f", [5, 3]]]}},
}


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
