"""The check fails its control and each fault it is there to catch.

The control is the reference put in the program's place in the
precision below the configuration's (``control.py``): bfloat16 for a
collective cell's float32, the cell reference's ``CONTROL`` for a train
step. The collectives' faults are planted underneath the timed path, in
the communicator the harness drives (the fusion buffer calls the same
methods), and the rest of the run is the harness's own; a train step's
are in ``test_harness_step.py``."""

import pytest
import torch

import control
from conftest import TINY, cells, collective_cells, kind_of


@pytest.mark.parametrize("workload", cells())
def test_control_is_not_correct(run_cpu, workload):
    step = kind_of(workload) == "step"
    program = control.control_step if step else control.control_program
    for seed in (11, 12, 2**31 + 13):
        r = run_cpu(workload, seed=seed, program=program)
        assert not r["correct"], r["checks"]
        if not step:
            assert r["checks"]["max_abs_gap"]["value"] >= 1.0


def _stale(orig):
    last = {}

    def call(x, *op):
        key = tuple(x.shape)
        if key not in last:
            last[key] = orig(x, *op)
        return last[key].clone()
    return call


def _half(orig):
    def call(x, *op):
        n = x.shape[0]
        y = x.clone()
        y[n // 2:] = x[:n // 2]  # half the ranks left out, the rest doubled
        return orig(y, *op)
    return call


def _no_exchange(orig):
    return lambda x, *op: x.clone()


def _altered(orig):
    def call(x, *op):
        out = orig(x, *op).clone()
        out.view(-1)[out.numel() // 2] += 1
        return out
    return call


FAULTS = {"stale": _stale, "half": _half, "no_exchange": _no_exchange,
          "altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", collective_cells())
def test_planted_fault_is_not_correct(run_cpu, workload, fault):
    import harness

    def broken(world, collective):
        for name in ("allreduce", "alltoall"):
            setattr(world, name, FAULTS[fault](getattr(world, name)))
        return harness.program_for(world, collective)

    r = run_cpu(workload, program=broken)
    assert not r["correct"], (fault, r["checks"])


@pytest.mark.cuda
def test_control_on_the_card():
    """The control on the card at a size a test run holds."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import time

    import harness
    from ompi_release_tpu_torch.runtime import runtime

    try:
        r = harness.run("allreduce_large.nccl_tests_8r", 5, 0.5, False,
                        t_start=time.perf_counter(), device="cuda",
                        overrides=TINY["allreduce_large.nccl_tests_8r"],
                        program=control.control_program)
    finally:
        runtime._reset_for_tests()
    assert not r["correct"]
