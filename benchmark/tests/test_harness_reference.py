"""The reference against the port on the CPU at tiny sizes: every cell
of ``BENCHMARK.json`` has its tiny sizes and its run comes out correct,
and the reference's results equal the port's outputs element for
element."""

import pytest
import torch

import reference
from conftest import HERE, TINY, cells


def test_every_cell_has_a_stand_in():
    missing = [w for w in cells() if w not in TINY]
    assert not missing, [str(HERE / "tiny" / f"{w}.json") for w in missing]


@pytest.mark.parametrize("workload", cells())
def test_cell_is_correct_on_the_cpu(run_cpu, workload):
    r = run_cpu(workload)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["outputs_compared"]["value"] >= 1
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("workload", cells())
def test_traced_cell_is_correct_on_the_cpu(run_cpu, workload):
    r = run_cpu(workload, trace=True)
    assert r["correct"], r["checks"]
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("collective", ["allreduce", "alltoall"])
def test_reference_equals_the_port(fresh_world, collective):
    import ompi_release_tpu_torch as mpi

    world = mpi.init(cli_args=["--mca", "runtime_virtual_ranks", "8",
                               "--mca", "coll", "tuned"], device="cpu")
    g = torch.Generator().manual_seed(3)
    ref = reference.for_collective(collective)
    for count in (8, 1000, 4096):
        x = torch.randint(-2**20, 2**20, (8, count), generator=g,
                          dtype=torch.float32)
        out = getattr(world, collective)(x)
        assert torch.equal(ref.compute(x, torch.float64).float(), out)
        assert ref.max_gap(x, out) == 0.0


def test_max_gap_sees_a_nan_and_one_changed_element():
    ref = reference.for_collective("allreduce")
    x = torch.ones(8, 5)
    out = ref.compute(x, torch.float32)
    out[3, 2] += 1
    assert ref.max_gap(x, out) == 1.0
    out[3, 2] = float("nan")
    assert ref.max_gap(x, out) == float("inf")
