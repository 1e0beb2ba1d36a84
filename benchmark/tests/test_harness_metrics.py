"""The metric arithmetic on a synthetic profiler table: each per-layer
metric's case (``metric_cases/<name>.json``, additions to the table's
ctx and the value the reader must give) found by the metric's name."""

import pytest

import devtrace
import harness
import metrics
from conftest import METRIC_CASES


def _synthetic():
    # window 0..10 ms; device ops, two of them overlapping
    dev = [("indexSelectLargeIndex", 0.001, 0.003),
           ("void axpy_kernel<float>", 0.0025, 0.004),
           ("Memcpy DtoD (Device -> Device)", 0.005, 0.006),
           ("CatArrayBatchedCopy", 0.008, 0.0085)]
    host = [(devtrace.WINDOW_SPAN, 0.0, 0.010),
            ("bench.dispatch", 0.0, 0.0009),
            ("bench.sync", 0.0065, 0.0079)]
    return dev, host


def test_busy_is_a_union_and_gaps_are_labelled():
    s = devtrace.reduce(*_synthetic())
    assert s["window_s"] == pytest.approx(0.010)
    assert s["busy_s"] == pytest.approx(0.003 + 0.001 + 0.0005)
    assert s["ops"]["void axpy_kernel<float>"] == (pytest.approx(0.0015), 1)
    gaps = dict(s["breakdown"]["idle_gaps"])
    assert gaps["bench.dispatch"] == pytest.approx(0.001)
    assert gaps["bench.sync"] == pytest.approx(0.002)
    assert s["breakdown"]["device_ops"][0][0] == "indexSelectLargeIndex"


def _ctx(extra=None):
    """The synthetic table's ctx, a case's additions merged over it (a
    dict-valued key one level deep)."""
    s = devtrace.reduce(*_synthetic())
    ctx = {"pvars": {"coll_invocations": 4,
                     "coll_orchestration_seconds": 0.0002,
                     "coll_plan_cache_hits": {"sum": 3.0, "count": 4}},
           "ops": s["ops"], "busy_s": s["busy_s"],
           "window_s": s["window_s"], "steps": 2,
           "least_bytes": 3.35e12 * 0.0009, "hbm_bytes_per_s": 3.35e12}
    for k, v in (extra or {}).items():
        ctx[k] = {**ctx[k], **v} if isinstance(ctx.get(k), dict) else v
    return ctx


def test_every_listed_metric_has_a_reader_and_a_case():
    for m in harness.load_benchmark()["per_layer"]:
        assert (metrics.DIR / f"{m['name']}.py").exists(), m["name"]
        assert m["name"] in METRIC_CASES, m["name"]


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_metric_that_lists_cells_lists_cells_that_exist(kind):
    bench = harness.load_benchmark()
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench[kind]:
        if "workloads" in m:
            assert m["workloads"], m["name"]
            assert set(m["workloads"]) <= cells, m["name"]


def test_every_listed_reader_on_the_synthetic_table():
    for m in harness.load_benchmark()["per_layer"]:
        case = METRIC_CASES[m["name"]]
        got = metrics.load(m["name"]).read(_ctx(case["ctx"]))
        assert got == pytest.approx(case["value"]), m["name"]


def test_sum_kernel_reads_the_ring_kernel_and_axpy():
    ring = "void (anonymous namespace)::ring_fold_kernel<float>(float*)"
    ctx = _ctx({"ops": {ring: (0.001, 1)}})
    read = metrics.load("sum_kernel_ms_per_call").read
    assert read(ctx) == pytest.approx((0.0015 + 0.001) / 4 * 1e3)
    del ctx["ops"]["void axpy_kernel<float>"]
    assert read(ctx) == pytest.approx(0.001 / 4 * 1e3)


def test_readers_return_nothing_when_there_is_nothing_to_read():
    empty = {"pvars": {}, "ops": {}, "busy_s": 0.0, "window_s": 0.0,
             "steps": 0, "least_bytes": 0.0, "hbm_bytes_per_s": None,
             "tokens": 0, "model_flops": 0, "peak_flops": None}
    for m in harness.load_benchmark()["per_layer"]:
        assert metrics.load(m["name"]).read(empty) is None, m["name"]


def test_end_to_end_readings():
    run = {"bus_bytes": 7e9, "window_s": 2.0, "memory_peak_bytes": 2**31,
           "setup_s": 3.5, "latencies": [1e-3, 2e-3, 3e-3, 4e-3, 5e-3]}
    assert harness.end_to_end("busbw_GBps", run) == pytest.approx(3.5)
    assert harness.end_to_end("busbw_GBps.sync", run) == pytest.approx(3.5)
    assert harness.end_to_end("latency_us_p50", run) == pytest.approx(3000)
    assert harness.end_to_end("latency_us_p95", run) == pytest.approx(4800)
    assert harness.end_to_end("peak_mem_GiB", run) == 2.0
    assert harness.end_to_end("setup_s", run) == 3.5


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end


class _Event:
    def __init__(self, name, device_type, start, end, annotation=False):
        self.name, self.device_type = name, device_type
        self.time_range = _Range(start, end)
        self.is_user_annotation = annotation


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_device_annotations_are_no_operations():
    prof = _Prof([
        _Event(devtrace.WINDOW_SPAN, "DeviceType.CPU", 0, 100),
        _Event("bench.dispatch", "DeviceType.CPU", 0, 10),
        _Event("bench.dispatch", "DeviceType.CUDA", 20, 90, True),
        _Event("gpu_user_span", "DeviceType.CUDA", 20, 90, True),
        _Event("axpy_kernel", "DeviceType.CUDA", 20, 30),
        _Event("indexSelect", "DeviceType.CUDA", 80, 90),
    ])
    dev, host = devtrace.events_of(prof)
    assert [d[0] for d in dev] == ["axpy_kernel", "indexSelect"]
    assert [h[0] for h in host] == [devtrace.WINDOW_SPAN, "bench.dispatch"]
    s = devtrace.reduce(dev, host)
    assert s["busy_s"] == pytest.approx(20e-6)
    assert s["window_s"] == pytest.approx(100e-6)
