"""The port's layers on the profiler's clock (``obs/spans.py``), on the
CPU: the gate, the ``mpi.*`` ranges of a dispatch, a fire and a fusion
flush under a CPU profiler, the device timers and event chains of
``mca/pvar.py`` on fake CUDA events, and the bytes ``stream_axpy``
launches move across a graph capture and its replays.

The gate is ``obs.enabled or torch.autograd.profiler._is_profiler_enabled``:
off, a site takes ``spans.OFF``, so no range, no CUDA event and no clock
read.
"""

import sys
import types
from pathlib import Path

import pytest
import torch
from torch.autograd import profiler as tprof

import ompi_release_tpu_torch as tmpi
from ompi_release_tpu_torch import obs
from ompi_release_tpu_torch import ops as tops
from ompi_release_tpu_torch.coll import driver, plan
from ompi_release_tpu_torch.coll.fusion import FusionBuffer
from ompi_release_tpu_torch.mca import pvar
from ompi_release_tpu_torch.mca import var as tvar
from ompi_release_tpu_torch.obs import spans
from ompi_release_tpu_torch.ops import cuda_op
from ompi_release_tpu_torch.runtime import runtime as trt

N = 8
BENCH = Path(__file__).resolve().parent.parent / "benchmark"


@pytest.fixture(scope="module")
def comm():
    trt._reset_for_tests()
    world = tmpi.init(cli_args=["--mca", "runtime_virtual_ranks", str(N)],
                      device="cpu")
    tvar.set_value("coll", "tuned")
    try:
        c = world.dup(name="spans_tuned")
    finally:
        tvar.VARS.unset("coll")
    yield c
    c.free()
    trt._reset_for_tests()
    tvar.VARS.unset("runtime_virtual_ranks")


def _x(count=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-100, 100, (N, count), generator=g).float()


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _frozen_with_graph():
    """A frozen plan whose 'graph' is a stand-in, so :meth:`fire` takes
    its card path on CPU tensors."""
    f = plan._Frozen(lambda x: x * 2)
    f.graph = _FakeGraph()
    f.static_in = torch.zeros(N, 16)
    f.static_out = torch.ones(N, 16)
    f.launches = {}
    f.copy_bytes = (2 * 512, 2 * 512)
    return f


@pytest.fixture
def counted(monkeypatch):
    """Counters on everything a site may do once its gate is on: open
    its steps, enter a range, make a CUDA event, read the steps' clock."""
    seen = {"span": 0, "range": 0, "event": 0, "clock": 0}
    real_steps, real_range = spans.Steps, spans._Range

    def steps(*a, **k):
        seen["span"] += 1
        return real_steps(*a, **k)

    def open_range(name):
        seen["range"] += 1
        return real_range(name)

    def event():
        seen["event"] += 1
        raise AssertionError("no CUDA event on the CPU")

    def clock():
        seen["clock"] += 1
        return 0.0

    monkeypatch.setattr(spans, "Steps", steps)
    monkeypatch.setattr(spans, "_Range", open_range)
    monkeypatch.setattr(pvar, "_new_event", event)
    monkeypatch.setattr(spans, "time", types.SimpleNamespace(
        perf_counter=clock))
    return seen


def _drive(comm):
    comm.allreduce(_x())
    fb = FusionBuffer(comm, threshold=1 << 20, capacity=1 << 20,
                      max_delay_us=10_000_000)
    hs = [fb.allreduce(_x(8, s), tops.SUM) for s in (1, 2)]
    fb.flush()
    _frozen_with_graph().fire(torch.full((N, 16), 3.0))
    return [h.result() for h in hs]


def test_gate_off_opens_nothing(comm, counted):
    assert not obs.enabled and not tprof._is_profiler_enabled
    out = _drive(comm)
    assert counted == {"span": 0, "range": 0, "event": 0, "clock": 0}
    want = _x(8, 1).sum(0)
    assert torch.equal(out[0][0], want)


def test_gate_on_under_the_profiler_opens_spans(comm, counted):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _drive(comm)
    # a range a step: the fire's three steps share one Steps; the host
    # timer of its replay step reads the clock twice; no CUDA event on
    # the CPU
    assert counted["span"] >= 4
    assert counted["range"] == counted["span"] + 2
    assert counted["event"] == 0 and counted["clock"] == 2


def _ranges(prof):
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("mpi.")),
                  key=lambda r: r[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_ranges_nest_under_a_cpu_profiler(comm):
    fb = FusionBuffer(comm, threshold=1 << 20, capacity=1 << 20,
                      max_delay_us=10_000_000)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = comm.allreduce(_x(32, 7))
        hs = [fb.allreduce(_x(8, s), tops.SUM) for s in (3, 4)]
        fb.flush()
        fused = [h.result() for h in hs]
    assert torch.equal(got[0], _x(32, 7).sum(0))
    assert torch.equal(fused[1][5], _x(8, 4).sum(0))
    rs = _ranges(prof)
    names = [r[0] for r in rs]
    for want in ("mpi.coll.allreduce", "mpi.fusion.flush",
                 "mpi.fusion.pack", "mpi.runner.allreduce"):
        assert want in names, names
    flush = next(r for r in rs if r[0] == "mpi.fusion.flush")
    pack = next(r for r in rs if r[0] == "mpi.fusion.pack")
    assert _inside(pack, flush)
    # the fused bucket's collective runs inside the flush, after the pack
    fused_coll = [r for r in rs if r[0] == "mpi.coll.allreduce"
                  and _inside(r, flush)]
    assert len(fused_coll) == 1 and fused_coll[0][1] >= pack[2]
    # the first, direct allreduce: its body launch inside its dispatch
    first = next(r for r in rs if r[0] == "mpi.coll.allreduce")
    assert not _inside(first, flush)
    assert any(r[0] == "mpi.runner.allreduce" and _inside(r, first)
               for r in rs)

    # the benchmark's gap labels name the innermost mpi.* range
    sys.path.insert(0, str(BENCH))
    try:
        import devtrace
    finally:
        sys.path.remove(str(BENCH))
    host = [(n, s / 1e6, e / 1e6) for n, s, e in rs]
    starts = [h[1] for h in host]
    mid = (pack[1] + pack[2]) / 2e6
    assert devtrace._host_label(mid, host, starts) == "mpi.fusion.pack"
    # a moment in the flush before its pack began: the flush names it
    early = (flush[1] + pack[1]) / 2e6
    assert flush[1] < pack[1]
    assert devtrace._host_label(early, host, starts) == "mpi.fusion.flush"


def test_fire_steps_are_ranges_in_order(comm):
    f = _frozen_with_graph()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = f.fire(torch.full((N, 16), 3.0))
        f.fire(f.static_in)  # read in place: no copy-in
    assert torch.equal(out, torch.ones(N, 16)) and f.graph.replays == 2
    assert [r[0] for r in _ranges(prof)] == [
        "mpi.plan.copy_in", "mpi.plan.replay", "mpi.plan.clone",
        "mpi.plan.replay", "mpi.plan.clone"]


def test_obs_on_feeds_the_host_launch_timer_without_a_profiler(comm):
    f = _frozen_with_graph()
    t = pvar.PVARS.lookup("coll_plan_launch_seconds")
    b = pvar.PVARS.lookup("coll_plan_copy_bytes")
    t0, b0 = t.read(), b.read()
    f.fire(torch.zeros(N, 16))
    assert (t.read(), b.read()) == (t0, b0)  # gate off: nothing
    obs.enable()
    try:
        f.fire(torch.zeros(N, 16))
        f.fire(f.static_in)
    finally:
        obs.disable()
    assert t.read() > t0
    # copy-in reads and writes 512 B, each clone 512 B twice
    assert b.read() - b0 == 2 * 512 + 2 * (2 * 512)


# ---------------------------------------------------------------------------
# pvar.DeviceTimer and pvar.EventChain on fake events
# ---------------------------------------------------------------------------

class _Clock:
    """The fake device: it has run every event recorded before ``done``
    (a record index); recording stamps an event with ``now`` ms."""

    def __init__(self):
        self.records, self.done, self.now = 0, 0, 0.0


class _FakeEvent:
    def __init__(self, clock):
        self.clock, self.seq, self.t = clock, None, None

    def record(self, stream=None):
        self.seq = self.clock.records
        self.clock.records += 1
        self.t = self.clock.now

    def query(self):
        return self.seq is None or self.seq < self.clock.done

    def elapsed_time(self, end):
        assert self.query() and end.query()
        return end.t - self.t


@pytest.fixture
def device(monkeypatch):
    """A fake card: events from ``_FakeEvent``, a fresh pool of at most
    ``device.pool(bound)`` events (4096 unless set), no real stream."""
    clock = _Clock()
    made = []

    def new_event():
        made.append(_FakeEvent(clock))
        return made[-1]

    def pool(bound=4096):
        monkeypatch.setattr(pvar, "EVENTS", pvar.EventPool(bound))
        return pvar.EVENTS

    monkeypatch.setattr(pvar, "_new_event", new_event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: None)
    clock.made, clock.pool = made, pool
    pool()
    return clock


def _interval(timer, clock, ms):
    ch = pvar.EventChain("cuda:0")
    ch.mark(timer)
    clock.now += ms
    ch.close()
    return ch


def test_device_timer_resolves_pending_pairs_on_read(device):
    t = pvar.DeviceTimer("t_resolve")
    for ms in (1.0, 2.0, 4.0):
        _interval(t, device, ms)
    pending = pvar.EVENTS._pending
    assert t.read() == 0.0 and len(pending) == 3  # nothing has run
    device.done = 4  # the first two chains' events have run
    assert t.read() == pytest.approx(0.003)
    assert len(pvar.EVENTS._pending) == 1
    device.done = device.records
    assert t.read() == pytest.approx(0.007)
    assert t.read() == pytest.approx(0.007)  # a chain counts once


def test_device_timer_reaps_on_stop_and_reuses_pairs(device):
    t = pvar.DeviceTimer("t_reuse")
    _interval(t, device, 1.0)
    device.done = device.records
    # the next chain's close finds the first one done: resolves it
    _interval(t, device, 2.0)
    assert t._value == pytest.approx(0.001)
    assert len(pvar.EVENTS._pending) == 1
    _interval(t, device, 4.0)  # ... and the third records into its events
    assert len(device.made) == 4
    device.done = device.records
    assert t.read() == pytest.approx(0.007)


def test_device_timer_reaps_on_start_when_the_pool_is_spent(device):
    device.pool(2)
    t = pvar.DeviceTimer("t_spent")
    d0 = pvar.device_timer_dropped.read()
    _interval(t, device, 1.0)
    device.done = device.records
    _interval(t, device, 2.0)  # no event free, none to make: reap, reuse
    assert pvar.device_timer_dropped.read() == d0
    assert len(device.made) == 2
    device.done = device.records
    assert t.read() == pytest.approx(0.003)


def test_device_timer_pending_list_is_bounded(device):
    device.pool(6)
    t = pvar.DeviceTimer("t_bound")
    d0 = pvar.device_timer_dropped.read()
    chains = [_interval(t, device, 1.0) for _ in range(5)]
    assert [c.events is None for c in chains] == [False] * 3 + [True] * 2
    assert pvar.device_timer_dropped.read() - d0 == 2
    assert len(pvar.EVENTS._pending) == 3 and len(device.made) == 6
    device.done = device.records
    assert t.read() == pytest.approx(0.003)
    _interval(t, device, 5.0)  # freed events time again
    assert len(device.made) == 6
    device.done = device.records
    assert t.read() == pytest.approx(0.008)
    assert pvar.device_timer_dropped.read() - d0 == 2


def test_device_timer_reset_forgets_pending_pairs(device):
    t = pvar.DeviceTimer("t_reset")
    _interval(t, device, 1.0)
    t.reset()
    device.done = device.records
    assert t.read() == 0.0
    _interval(t, device, 2.0)
    device.done = device.records
    assert t.read() == pytest.approx(0.002) and len(device.made) == 2


def test_event_chain_shares_each_boundary_between_two_timers(device):
    a, b = pvar.DeviceTimer("t_a"), pvar.DeviceTimer("t_b")
    ch = pvar.EventChain("cuda:0")
    for timer, ms in ((a, 1.0), (b, 2.0), (None, 8.0), (a, 4.0)):
        ch.mark(timer)
        device.now += ms
    ch.close()
    assert len(device.made) == 5  # four intervals, five boundaries
    device.done = device.records
    assert (a.read(), b.read()) == (pytest.approx(0.005),
                                    pytest.approx(0.002))


class _Card:
    """A stand-in for a CUDA device (hashable, as a pool key)."""
    type = "cuda"


def _three_steps(device, a, b):
    with spans.Steps(_Card()) as st:
        st.step("plan", "copy_in", a)
        device.now += 1.0
        st.step("plan", "replay", b)
        device.now += 2.0
        st.step("plan", "clone", a)
        device.now += 4.0
    device.done = device.records


@pytest.mark.parametrize("capturing", [False, True])
def test_steps_record_one_event_a_boundary_and_none_in_a_capture(
        device, monkeypatch, capturing):
    monkeypatch.setattr(obs, "enabled", True)
    monkeypatch.setattr(spans, "_capturing", lambda: capturing)
    a, b = pvar.DeviceTimer("t_sa"), pvar.DeviceTimer("t_sb")
    _three_steps(device, a, b)
    assert len(device.made) == (0 if capturing else 4)
    assert a.read() == pytest.approx(0.0 if capturing else 0.005)
    assert b.read() == pytest.approx(0.0 if capturing else 0.002)


def test_steps_under_a_profiler_alone_record_no_event(device, monkeypatch):
    monkeypatch.setattr(spans, "_capturing", lambda: False)
    a, b = pvar.DeviceTimer("t_pa"), pvar.DeviceTimer("t_pb")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _three_steps(device, a, b)
    assert not obs.enabled and not device.made
    assert (a.read(), b.read()) == (0.0, 0.0)
    assert [e.name for e in prof.events() if e.name.startswith("mpi.")] \
        == ["mpi.plan.copy_in", "mpi.plan.replay", "mpi.plan.clone"]


def test_registered_device_timers():
    for name in ("coll_plan_copy_device_seconds",
                 "coll_runner_device_seconds",
                 "coll_fusion_pack_device_seconds"):
        pv = pvar.PVARS.lookup(name)
        assert isinstance(pv, pvar.DeviceTimer), name
        assert pv.pclass is pvar.PvarClass.TIMER
    assert pvar.device_timer("coll_runner_device_seconds") is \
        driver.runner_device
    assert pvar.PVARS.lookup("device_timer_dropped") is \
        pvar.device_timer_dropped


# ---------------------------------------------------------------------------
# stream_axpy bytes across a capture and its replays
# ---------------------------------------------------------------------------

@pytest.fixture
def launcher(monkeypatch):
    def launch(kernel, counter, device, *args):
        cuda_op.LAUNCHES[counter] += 1

    monkeypatch.setattr(cuda_op, "_launch", launch)
    cuda_op.reset_launches()
    yield
    cuda_op.reset_launches()


@pytest.mark.parametrize("replays", [0, 1, 5])
def test_replays_credit_the_captured_bytes(launcher, replays):
    x = torch.empty(1000, device="meta")
    h = torch.empty(1000, dtype=torch.bfloat16, device="meta")
    cuda_op.sum_(x, x)  # eager: counted where it ran
    eager = cuda_op.BYTES["stream_axpy_bytes"]
    assert eager == 3 * 1000 * 4
    before = cuda_op.counts()
    cuda_op.sum_(x, x)  # "captured": taken back out below
    cuda_op.axpy(h, h, 2.0)
    captured = cuda_op.take_launches(before)
    assert captured == {"sum": 1, "axpy": 1,
                        "stream_axpy_bytes": 3 * 1000 * 4 + 3 * 1000 * 2}
    assert cuda_op.counts() == before
    for _ in range(replays):
        cuda_op.count_replay(captured)
    assert cuda_op.BYTES["stream_axpy_bytes"] == \
        eager + replays * captured["stream_axpy_bytes"]
    assert cuda_op.LAUNCHES["sum"] == 1 + replays
    read = pvar.PVARS.read_all()
    assert read["op_stream_axpy_bytes"] == cuda_op.BYTES[
        "stream_axpy_bytes"]
    assert read["op_sum_launches"] == 1 + replays
    assert read["op_axpy_launches"] == replays


def test_a_launches_only_mark_leaves_the_bytes(launcher):
    x = torch.empty(10, device="meta")
    before = dict(cuda_op.LAUNCHES)
    cuda_op.sum_(x, x)
    assert cuda_op.take_launches(before) == {"sum": 1}
    assert cuda_op.BYTES["stream_axpy_bytes"] == 120
