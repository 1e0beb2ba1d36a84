"""The port bench's new micro-suites held against bench.py's.

- ``coll_micro_suite`` against bench.py's ``_coll_micro_suite``, both
  in this process on 8 ranks: the same lines in the same order (bench.py's
  ``coll_pipeline_allreduce_1MiB_sampled`` waits for the observability
  plane), the same fusion outcome (the 64 tensors fused into fewer
  collectives than tensors; one on an idle host).
- ``native_rounds_suite`` (a 3-process job; each leg bitwise its
  interpreted twin and the >= 2x orchestration factor asserted in-app)
  against bench.py's ``_native_rounds_micro_suite`` run the same way: the
  same line names in the same order, the C executor firing every replay.
- ``native_wire_suite`` (with its QoS leg), ``overlap_suite`` and
  ``steady_spanning_suite`` emit bench.py's line names in bench.py's
  order.
- ``ft_suite`` emits ``_ft_micro_suite``'s line names from one real
  recovery (a 3-process ``--ft-continue`` job).
"""

import numpy as np
import pytest
import torch

import bench as jbench
from ompi_release_tpu_torch import bench as tbench


@pytest.fixture
def fresh_runtime():
    from ompi_release_tpu_torch.runtime import runtime as trt

    trt._reset_for_tests()
    yield
    trt._reset_for_tests()


def _names(lines):
    return [ln["metric"] for ln in lines]


def test_coll_micro_suite_matches_bench_py(fresh_runtime):
    ours = tbench.coll_micro_suite(torch.device("cpu"), reps=1)
    theirs = jbench._coll_micro_suite()
    assert _names(ours) == _names(theirs) == [
        "coll_pipeline_allreduce_1MiB", "coll_pipeline_bcast_1MiB",
        "coll_pipeline_allreduce_1MiB_sampled", "coll_fusion_64x1KiB"]
    sampled = ours[2]
    assert sampled["unit"] == "x_vs_sampled_run" and sampled["value"] > 0
    assert sampled["seconds"] > 0 and sampled["unsampled_seconds"] > 0
    # one collective for the 64 tensors on an idle host; the buffer's
    # latency bound (coll_fusion_max_delay_us, the same rule in both
    # packages) flushes early when a busy host stretches the burst, so
    # the claim held is the suite's own: fewer collectives than tensors
    fo, ft = ours[-1], theirs[-1]
    assert fo["tensors_fused"] == ft["tensors_fused"] == 64
    assert 1 <= fo["value"] < 64 and 1 <= ft["value"] < 64
    assert fo["fewer_collectives_than_tensors"]
    assert ft["fewer_collectives_than_tensors"]
    for ln in ours[:2]:
        assert ln["value"] > 0 and ln["unit"] == "GB/s"
        assert ln["suite"] == "coll_pipeline"
        assert ln["pvars"]["coll_compiled_cache_hits"]["count"] > 0


def test_native_rounds_suite_matches_bench_py():
    ours = tbench.native_rounds_suite(torch.device("cpu"))
    theirs = jbench._native_rounds_micro_suite()
    assert _names(ours) == _names(theirs)
    by = {ln["metric"]: ln for ln in ours}
    pool = by["native_rounds_pool"]
    assert pool["native_fallbacks"] == 0
    assert pool["native_fires"] >= 6 * 8  # six cases x 8 replays
    for label in ("allreduce_4KiB", "allreduce_256KiB"):
        assert by[f"compiled_native_{label}_orch_speedup"]["value"] >= 2.0


def test_native_wire_suite_lines():
    sizes = [1 << 20, 4 << 20]
    lines = tbench.native_wire_suite(torch.device("cpu"), sizes, 8)
    want = ["wire_native_p2p_1MiB", "wire_native_p2p_4MiB",
            "wire_native_hol_2x8MiB_lanes4", "wire_native_hol_2x8MiB_lanes1",
            "wire_native_copies_per_mib", "wire_native_p2p_tcp_1MiB",
            "wire_native_p2p_tcp_4MiB", "wire_staged_p2p_1MiB",
            "wire_staged_p2p_4MiB", "wire_native_qos_latency_solo_s",
            "wire_native_qos_latency_under_bulk_s",
            "wire_native_shm_speedup_vs_staged"]
    assert _names(lines) == want
    by = {ln["metric"]: ln for ln in lines}
    assert by["wire_native_copies_per_mib"]["value"] == 0
    assert by["wire_native_copies_per_mib"]["native_bytes"] > 0
    assert all(ln["value"] > 0 for ln in lines
               if ln["unit"] in ("GB/s", "s"))
    for name in want[-3:-1]:
        assert by[name]["unit"] == "s" and by[name]["value"] > 0
        assert by[name]["suite"] == "native_wire"
        assert by[name]["qos_classes"] == "latency:3,bulk:1"


def test_native_wire_line_names_follow_bench_py():
    """Every line name ``native_wire_suite`` can emit appears in
    bench.py's native_wire app or suite, the QoS leg's included, and
    the port's legs run in bench.py's mode order (shm, tcp, qos)."""
    import inspect
    import re

    src = inspect.getsource(jbench._native_wire_micro_suite) \
        + jbench._NATIVE_WIRE_BENCH_APP
    for name in ("wire_native_qos_latency_solo_s",
                 "wire_native_qos_latency_under_bulk_s",
                 "wire_native_shm_speedup_vs_staged",
                 "wire_native_copies_per_mib"):
        assert f'"{name}"' in src
    modes = re.findall(r'\("(shm|tcp|qos)", ', inspect.getsource(
        jbench._native_wire_micro_suite))
    assert modes == ["shm", "tcp", "qos"]
    port = inspect.getsource(tbench.native_wire_suite)
    assert port.index('"shm", "tcp"') < port.index("native_wire_qos_leg")


def test_overlap_and_steady_spanning_lines():
    lines = tbench.overlap_suite(torch.device("cpu"))
    assert _names(lines) == ["overlap_allreduce_hidden_frac",
                             "overlap_allreduce_hidden_frac_polling",
                             "overlap_allreduce_speedup"]
    assert lines[1]["value"] == 0.0  # polling hides nothing
    assert np.isfinite(lines[0]["value"])
    span = tbench.steady_spanning_suite(torch.device("cpu"))
    assert _names(span) == [
        "steady_orch_spanning_allreduce_256KiB_interpreted",
        "steady_orch_spanning_allreduce_256KiB_compiled",
        "compiled_spanning_allreduce_orch_speedup",
        "steady_obs_orch_spanning_allreduce_256KiB_compiled",
        "steady_obs_overhead_spanning_allreduce_256KiB",
        "ledger_record_bytes_spanning_allreduce_256KiB",
        "obs_ledger_trace_spanning_allreduce_256KiB"]
    assert all(ln["suite"] == "steady_state" for ln in span)
    by = {ln["metric"]: ln for ln in span}
    assert by["steady_obs_overhead_spanning_allreduce_256KiB"]["budget"] \
        == 1.15
    assert by["obs_ledger_trace_spanning_allreduce_256KiB"][
        "paired_flows"] > 0


def test_ft_suite_matches_bench_py_names():
    """The port's ``ft`` lines carry ``_ft_micro_suite``'s names: one
    recovery of a 3-process ``--ft-continue`` job whose worker 2 the
    sensor kills at step 3, detected once and recovered once in-app."""
    import inspect

    ours = tbench.ft_suite(torch.device("cpu"))
    src = inspect.getsource(jbench) + jbench._FT_BENCH_APP
    want = ["ft_recovery_seconds", "ft_steps_lost"]
    assert _names(ours) == want
    for name in want:
        assert f'"metric": "{name}"' in src
    by = {ln["metric"]: ln for ln in ours}
    rec = by["ft_recovery_seconds"]
    assert rec["suite"] == by["ft_steps_lost"]["suite"] == "ft_recovery"
    assert rec["failures_detected"] == 1.0 and rec["recoveries"] == 1.0
    assert 0 < rec["value"] < 30
    assert by["ft_steps_lost"]["value"] == 0  # checkpoint_every 1
