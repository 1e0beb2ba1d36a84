"""The port's observability plane (``ompi_release_tpu_torch/obs/``) held
against the JAX package's: the journal, flow ids, the skew timers, the
exporters, the emit sites of the in-process collectives and p2p, the
selftest entry point, the disabled-mode cost and the static gating of
every hot-path emit site.

Span lists: the same tuned in-process collectives and p2p on 8 ranks
(two warm-up allreduces first: the JAX package registers cvars inside
its first collective, which moves the write generation and re-captures
the plan once more) give the same spans by (op, layer, nbytes, peer,
comm) in both packages, with one difference by design: the JAX
package's in-process PML moves a payload through a BTL module, whose
move is a ``move[ici]`` span; the port's PML copies on the device
directly (``p2p/pml.py``), so it has no such span. Frozen plan fires
leave the same ledger records in both.

Exporters: the same spans and pvars give identical Chrome trace,
JSONL, Prometheus and OpenMetrics text.
"""

import ast
import importlib
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import ompi_release_tpu as jmpi
from ompi_release_tpu import obs as jobs
from ompi_release_tpu.mca import pvar as jpvar
from ompi_release_tpu.mca import var as jvar
from ompi_release_tpu.obs import export as jexport
from ompi_release_tpu.obs import ledger as jledger
import ompi_release_tpu_torch as tmpi
from ompi_release_tpu_torch import obs as tobs
from ompi_release_tpu_torch.mca import pvar as tpvar
from ompi_release_tpu_torch.mca import var as tvar
from ompi_release_tpu_torch.obs import export as texport
from ompi_release_tpu_torch.obs import ledger as tledger
from ompi_release_tpu_torch.runtime import runtime as trt

import test_obs_gating as gating

# the obs packages bind ``journal`` to the journal INSTANCE: reach the
# submodules by name
jjournal = importlib.import_module("ompi_release_tpu.obs.journal")
tjournal = importlib.import_module("ompi_release_tpu_torch.obs.journal")

N = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (jobs, jpvar, jexport, jjournal),
        "torch": (tobs, tpvar, texport, tjournal)}


@pytest.fixture(scope="module")
def comms():
    """A tuned communicator on each side."""
    jworld = jmpi.init()
    trt._reset_for_tests()
    tworld = tmpi.init(cli_args=["--mca", "runtime_virtual_ranks", str(N)],
                       device="cpu")
    jvar.set_value("coll", "tuned")
    tvar.set_value("coll", "tuned")
    try:
        jc = jworld.dup(name="obs_tuned")
        tc = tworld.dup(name="obs_tuned")
    finally:
        jvar.VARS.unset("coll")
        tvar.VARS.unset("coll")
    yield jc, tc
    jc.free()
    tc.free()
    trt._reset_for_tests()
    tvar.VARS.unset("runtime_virtual_ranks")


@pytest.fixture()
def planes():
    """Both planes off and empty around the test (the flag, the journal
    and the ledger are process-global)."""
    for o in (jobs, tobs):
        o.disable()
        o.journal.clear()
    jledger._reset_for_tests()
    tledger._reset_for_tests()
    yield
    for o in (jobs, tobs):
        o.disable()
        o.journal.clear()
    jledger._reset_for_tests()
    tledger._reset_for_tests()


# ---------------------------------------------------------------------------
# journal, flow ids, skew
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_flow_id_bitwise(seed):
    rs = np.random.RandomState(seed)
    for _ in range(50):
        parts = tuple(
            rs.choice(["hier", "p2p", "win", "nw", "sig"]) if k == 0
            else int(rs.randint(-5, 1 << 40)) for k in range(
                rs.randint(1, 7)))
        assert tjournal.flow_id(*parts) == jjournal.flow_id(*parts)
    assert tjournal.flow_id() == jjournal.flow_id() != 0


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_journal_ring_resize_clear(pkg):
    _, _, _, jr = PKGS[pkg]
    j = jr.Journal(4)
    for i in range(10):
        j.record(f"op{i}", "t", float(i), 0.5, nbytes=i)
    assert [s.op for s in j.snapshot()] == ["op6", "op7", "op8", "op9"]
    assert j.dropped == 6 and j.total_recorded == 10
    j.resize(2)
    assert [s.op for s in j.snapshot()] == ["op8", "op9"]
    assert j.dropped == 8
    j.clear()
    sp = j.record("x", "t", 0.0, 0.0, flow=7, flow_side="s")
    assert sp.seq == 10 and sp.asdict()["fs"] == "s" and len(j) == 1


def _spans(jr, n=12):
    rs = np.random.RandomState(3)
    j = jr.Journal(64)
    for i in range(n):
        j.record(f"op{i % 3}", ("coll", "hier", "pml")[i % 3],
                 float(rs.rand() * 100), float(rs.rand()) * (i % 2),
                 nbytes=int(rs.randint(0, 1 << 20)),
                 peer=int(rs.randint(-1, 8)), comm_id=int(rs.randint(0, 4)),
                 flow=int(rs.randint(0, 3)) * 12345,
                 flow_side="st"[i % 2])
    return j.snapshot()


def test_chrome_trace_and_jsonl_identical(tmp_path):
    jt = jexport.chrome_trace(_spans(jjournal))
    tt = texport.chrome_trace(_spans(tjournal))
    assert tt == jt
    a = jexport.dump_jsonl(str(tmp_path / "j.jsonl"), _spans(jjournal))
    b = texport.dump_jsonl(str(tmp_path / "t.jsonl"), _spans(tjournal))
    assert open(a, "rb").read() == open(b, "rb").read()


def _registry(pv):
    reg = pv.PvarRegistry()
    c = reg.register("x_counter", pv.PvarClass.COUNTER, "a counter")
    c.add(5)
    t = reg.register("x_timer", pv.PvarClass.TIMER, "a timer")
    t.add(0.25)
    h = reg.register("x_hist", pv.PvarClass.HISTOGRAM, "a histogram")
    for v in (0.0, 1e-4, 3.0, 4.0, 1024.0):
        h.observe(v)
    a = reg.register("x_agg", pv.PvarClass.AGGREGATE, "an aggregate")
    a.observe(2.0)
    a.observe(-1.0)
    reg.register("x_getter", pv.PvarClass.LEVEL, "a getter",
                 getter=lambda: 7)
    reg.register("x_text", pv.PvarClass.LEVEL, "a text getter",
                 getter=lambda: "n/a")
    return reg


def test_prometheus_text_identical():
    assert texport.prometheus_text(_registry(tpvar)) == \
        jexport.prometheus_text(_registry(jpvar))


def test_openmetrics_series_identical():
    pts = [{"i": 0, "t": 1.5, "cid": -1, "name": "x_counter", "v": 4.0},
           {"i": 1, "t": 1.5, "cid": 3, "name": "coll_ops", "v": 2.0},
           {"i": 2, "t": 2.5, "cid": -1, "name": "x_hist",
            "v": {"count": 3.0, "sum": 9.0, "min": 1.0, "max": 4.0,
                  "buckets": {"1.0": 1.0, "4.0": 2.0}}},
           {"i": 3, "t": 2.5, "cid": 0, "name": "x_text", "v": "n/a"}]
    for kw in ({}, {"pidx": 1, "clock_offset_s": 0.125}):
        assert texport.openmetrics_series(pts, **kw) == \
            jexport.openmetrics_series(pts, **kw)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_skew_timer_pvars(pkg, planes):
    o, pv, _, _ = PKGS[pkg]
    from importlib import import_module

    skew = import_module(o.__name__ + ".skew")
    tok = skew.begin("obsparity", 5)
    skew.body(tok)
    skew.end(tok, nbytes=96)
    assert pv.PVARS.lookup("coll_obsparity_skew_seconds").read()[
        "count"] >= 1
    assert pv.PVARS.lookup("coll_obsparity_msg_bytes").read()["count"] >= 1
    sp = o.journal.snapshot()[-1]
    assert (sp.op, sp.layer, sp.nbytes, sp.comm_id) == (
        "obsparity", "coll", 96, 5)


# ---------------------------------------------------------------------------
# emit sites: the same calls give the same spans and ledger records
# ---------------------------------------------------------------------------

def _drive(c):
    x = np.random.RandomState(0).randn(N, 64).astype(np.float32)
    for _ in range(2):
        c.allreduce(x)  # frozen fires: ledger records, no spans
    c.bcast(x, root=3)
    c.allgather(x[:, :8])
    c.alltoall(np.arange(N * N, dtype=np.float32).reshape(N, N))
    c.reduce(x, root=1)
    req = c.isend(np.arange(16, dtype=np.float32), 2, tag=5, rank=1)
    c.recv(source=1, tag=5, rank=2)
    req.wait()


def test_span_lists_and_ledger_match_jax(comms, planes):
    jc, tc = comms
    x = np.random.RandomState(0).randn(N, 64).astype(np.float32)
    got = {}
    for pkg, c, o, led in (("jax", jc, jobs, jledger),
                           ("torch", tc, tobs, tledger)):
        for _ in range(2):  # capture, then the JAX package's re-capture
            c.allreduce(x)
        o.journal.clear()
        o.enable()
        try:
            _drive(c)
        finally:
            o.disable()
        spans = [(s.op, s.layer, s.nbytes, s.peer,
                  "C" if s.comm_id == c.cid else s.comm_id)
                 for s in o.journal.snapshot()
                 if not (s.layer == "btl" and s.op.startswith("move["))]
        recs = [(r["kind"], led.plans()[r["plan"]]["name"],
                 led.plans()[r["plan"]]["nbytes"])
                for r in led.records()]
        got[pkg] = (spans, recs)
    assert got["torch"] == got["jax"]
    spans, recs = got["torch"]
    assert recs == [(tledger.KIND_DEVICE, "allreduce", N * 64 * 4)] * 2
    assert {"coll", "plan", "pml", "peruse", "request"} <= {
        s[1] for s in spans}


def test_disabled_records_nothing(comms, planes):
    _, tc = comms
    tc.allreduce(np.ones((N, 8), np.float32))
    tc.bcast(np.ones((N, 8), np.float32), root=0)
    assert len(tobs.journal) == 0 and not tledger.records()


def test_disabled_overhead_guard(comms, planes):
    """The plane's whole disabled-mode cost is its emit gates: 16 of
    them must cost under 5 % of a small in-process allreduce."""
    _, tc = comms
    x = np.ones((N, 256), np.float32)
    tc.allreduce(x)

    def loop(k):
        t0 = time.perf_counter()
        for _ in range(k):
            tc.allreduce(x)
        return time.perf_counter() - t0

    per_call = min(loop(50) for _ in range(3)) / 50
    k = 200_000
    t0 = time.perf_counter()
    for _ in range(k):
        if tobs.enabled:
            pass  # pragma: no cover
    gate = (time.perf_counter() - t0) / k
    assert gate * 16 < 0.05 * per_call, (gate, per_call)


def test_enable_after_init_installs_the_signal_handlers(monkeypatch):
    """``obs.enable()`` on a live port runtime installs the SIGUSR1 and
    fatal-signal handlers (it probes the port's runtime module)."""
    from ompi_release_tpu_torch.obs import watchdog

    calls = []
    monkeypatch.setattr(watchdog, "install_signal_handlers",
                        lambda: calls.append(1))
    live = type("R", (), {"initialized": True, "finalized": False})()
    monkeypatch.setattr(trt.Runtime, "_instance", live)
    try:
        tobs.enable()
    finally:
        tobs.disable()
    assert calls == [1]


def test_rank_identity_reads_the_port_runtime(monkeypatch):
    rt = type("R", (), {"bootstrap": {"process_index": 3},
                        "local_rank_offset": 12, "local_size": 4,
                        "endpoints": ()})()
    monkeypatch.setattr(trt.Runtime, "_instance", rt)
    ident = tobs.rank_identity()
    assert (ident["pidx"], ident["rank_offset"], ident["local_size"]) == (
        3, 12, 4)


def test_selftest_entry_point():
    """``python -m ompi_release_tpu_torch.obs --selftest`` runs every
    pvar class, exporter, the sampler, sentinel, ledger and native
    legs host-only."""
    env = dict(os.environ)
    env.pop("OMPI_TPU_OBS", None)
    proc = subprocess.run(
        [sys.executable, "-m", "ompi_release_tpu_torch.obs", "--selftest"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "obs selftest: ok" in proc.stdout


def test_port_obs_imports_no_jax():
    code = ("import sys; import ompi_release_tpu_torch.obs.__main__, "
            "ompi_release_tpu_torch.tools.tpu_doctor, "
            "ompi_release_tpu_torch.tools.tpu_ps, "
            "ompi_release_tpu_torch.tools.trace; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'ompi_release_tpu' or "
            "m.startswith('ompi_release_tpu.')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# gating: tests/test_obs_gating.py's AST scan over the port's hot paths
# ---------------------------------------------------------------------------

PORT_CHECKED = tuple(
    f.replace("ompi_release_tpu/", "ompi_release_tpu_torch/", 1)
    for f in gating.CHECKED
    if not f.startswith(("ompi_release_tpu/service/",
                         "ompi_release_tpu/tuning/retune")))


@pytest.mark.parametrize("rel", PORT_CHECKED)
def test_port_hot_path_emit_sites_are_gated(rel):
    assert not gating._scan_file(rel)
    src = open(os.path.join(REPO, rel)).read()
    assert "_obs.enabled" in src and "_obs.record" in src, rel


def test_port_watchdog_arm_sites_are_gated_and_present():
    armed = 0
    for rel in ("runtime/wire.py", "coll/hier.py", "osc/wire_win.py",
                "p2p/pml.py", "btl/nativewire.py", "runtime/progress.py",
                "coll/native_exec.py"):
        src = open(os.path.join(REPO, "ompi_release_tpu_torch", rel)).read()
        assert "_watchdog.enabled" in src and "_watchdog.arm(" in src, rel
        armed += src.count("_watchdog.arm(")
    assert armed >= 14, armed


@pytest.mark.parametrize("rel", ["ompi_release_tpu_torch/coll/hier.py",
                                 "ompi_release_tpu_torch/p2p/pml.py",
                                 "ompi_release_tpu_torch/coll/plan.py"])
def test_checker_catches_a_planted_violation(rel):
    """An ungated journal emit planted into a real port file is caught
    (the static check is no rubber stamp)."""
    src = open(os.path.join(REPO, rel)).read()
    tree = ast.parse(src)
    planted = ast.parse(
        "def _planted(x):\n"
        "    _obs.record('planted', 'x', 0.0, 0.0)\n"
        "    tok = _watchdog.arm('planted')\n").body[0]
    tree.body.append(planted)
    pvars = gating._module_pvars(tree)
    violations = []
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            gating._scan_stmts(node.body, False, pvars, violations, rel,
                               gating._module_containers(tree)
                               | gating._bound_containers(node))
    assert len(violations) == 2, violations
    assert "record" in violations[0] and "arm" in violations[1]
