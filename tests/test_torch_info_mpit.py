"""What slice 1 left out of the port's ``comm``, ``runtime`` and ``mca``,
held case for case against the JAX package.

Each case of ``tests/test_runtime_comm.py::TestInfo``, its environment
surface (``finalized``, ``wtime``, ``wtick``, ``get_version``), the
``runtime_timing`` report, ``split_type_shared``, ``submesh`` and the
MPI_T cases of ``tests/test_observability.py`` runs on both packages
(parametrised by package) with the same expectations. The port's
runtime is brought up on the CPU with 8 virtual ranks, the JAX
package's on its 8 virtual CPU devices.
"""

import subprocess
import sys

import pytest

import ompi_release_tpu as jmpi
import ompi_release_tpu_torch as tmpi
from ompi_release_tpu.comm import info as jinfo
from ompi_release_tpu.mca import mpit as jmpit
from ompi_release_tpu.mca import pvar as jpvar
from ompi_release_tpu.mca import var as jvar
from ompi_release_tpu.utils.errors import MPIError as JMPIError
from ompi_release_tpu_torch.comm import info as tinfo
from ompi_release_tpu_torch.mca import mpit as tmpit
from ompi_release_tpu_torch.mca import pvar as tpvar
from ompi_release_tpu_torch.mca import var as tvar
from ompi_release_tpu_torch.runtime import runtime as trt
from ompi_release_tpu_torch.utils.errors import MPIError as TMPIError

from conftest import subprocess_env

PKGS = {
    "jax": dict(mpi=jmpi, info=jinfo, mpit=jmpit, pvar=jpvar, var=jvar,
                error=JMPIError),
    "torch": dict(mpi=tmpi, info=tinfo, mpit=tmpit, pvar=tpvar, var=tvar,
                  error=TMPIError),
}
both = pytest.mark.parametrize("pkg", sorted(PKGS))


@pytest.fixture
def world(request):
    """WORLD of 8 ranks of the package under test; the port's runtime is
    torn down afterwards."""
    pkg = request.node.callspec.params["pkg"]
    if pkg == "jax":
        yield jmpi.init()
        return
    trt._reset_for_tests()
    yield tmpi.init(cli_args=["--mca", "runtime_virtual_ranks", "8"],
                    device="cpu")
    trt._reset_for_tests()
    tvar.VARS.unset("runtime_virtual_ranks")


@pytest.fixture
def fresh(request, monkeypatch):
    """Isolated var/pvar registries of the package under test."""
    m = PKGS[request.node.callspec.params["pkg"]]
    monkeypatch.setattr(m["var"], "VARS", m["var"].VarRegistry())
    monkeypatch.setattr(m["pvar"], "PVARS", m["pvar"].PvarRegistry())
    return m


# ---------------------------------------------------------------------------
# MPI_Info (tests/test_runtime_comm.py::TestInfo)
# ---------------------------------------------------------------------------

@both
def test_info_set_get_delete_order(pkg):
    m = PKGS[pkg]
    info = m["info"].Info()
    info.set("alpha", "1")
    info.set("beta", "2")
    info.set("alpha", "3")  # overwrite keeps position
    assert info.nkeys == 2
    assert info.get("alpha") == "3"
    assert info.get("missing") is None  # flag=false, not an error
    assert [info.nthkey(i) for i in range(2)] == ["alpha", "beta"]
    info.delete("alpha")
    for bad in (lambda: info.delete("alpha"), lambda: info.nthkey(5),
                lambda: info.set("", "x"), lambda: info.set("k" * 300, "x"),
                lambda: info.set("k", "v" * 1025)):
        with pytest.raises(m["error"]):
            bad()


@both
def test_info_dup_is_independent(pkg):
    a = PKGS[pkg]["info"].Info({"k": "v"})
    b = a.dup()
    b.set("k", "w")
    assert a.get("k") == "v" and b.get("k") == "w"
    assert list(a.items()) == [("k", "v")] and len(b) == 1 and "k" in b


def test_info_env_has_the_same_reserved_keys():
    for key in ("command", "argv", "wdir", "thread_level"):
        assert key in tinfo.INFO_ENV
    assert tinfo.INFO_ENV.as_dict() == jinfo.INFO_ENV.as_dict()
    assert tmpi.comm.INFO_NULL is None and tmpi.comm.Info is tinfo.Info


@both
def test_comm_info_dup_semantics(pkg, world):
    c = world.dup(name="info_parent")
    c.info.set("io_hint", "collective")
    d = c.dup(name="info_child")
    assert d.info.get("io_hint") == "collective"
    d.info.set("io_hint", "independent")
    assert c.info.get("io_hint") == "collective"  # deep copy
    s = c.split([0] * c.size)[0]  # split and create inherit it too
    assert s.info.get("io_hint") == "collective"
    assert world.info.get("io_hint") is None
    for comm in (s, d, c):
        comm.free()


# ---------------------------------------------------------------------------
# split_type_shared, submesh (tests/test_runtime_comm.py)
# ---------------------------------------------------------------------------

@both
def test_split_type_shared(pkg, world):
    comms = world.split_type_shared()
    # one controller process: everyone lands in one shared comm
    assert len(comms) == 8 and all(c is comms[0] for c in comms)
    assert comms[0].size == 8 and comms[0].group.world_ranks == tuple(range(8))
    comms[0].free()


@both
def test_submesh_follows_group_order(pkg, world):
    sub = world.create(world.group.incl([5, 1, 3]), name="scrambled")
    devs = list(sub.submesh.devices.reshape(-1))
    world_devs = list(world.submesh.devices.reshape(-1))
    assert sub.submesh.axis_names == ("rank",)
    assert devs == [world_devs[r] for r in (5, 1, 3)]  # group order kept
    if pkg == "torch":  # 8 virtual ranks share the one device
        assert devs == [sub.device] * 3
    sub.free()


# ---------------------------------------------------------------------------
# the environment surface (tests/test_runtime_comm.py)
# ---------------------------------------------------------------------------

@both
def test_env_utility_surface(pkg, world):
    mpi = PKGS[pkg]["mpi"]
    assert mpi.initialized() is True
    assert mpi.finalized() is False
    t0 = mpi.wtime()
    assert mpi.wtime() >= t0
    assert 0 < mpi.wtick() < 1
    ver, level = mpi.get_version()
    assert ver and "1.8.5" in level
    assert "unknown" in mpi.error_string(99999)


def test_finalized_after_finalize():
    trt._reset_for_tests()
    try:
        tmpi.init(device="cpu")
        assert tmpi.finalized() is False
        tmpi.finalize()
        assert tmpi.finalized() is True and tmpi.initialized() is False
    finally:
        trt._reset_for_tests()
    assert tmpi.finalized() is False  # a fresh runtime


@both
def test_init_timing_report(pkg):
    """With ``runtime_timing`` set, init reports per-stage durations from
    the job state machine's history on stderr."""
    mod = "ompi_release_tpu" if pkg == "jax" else "ompi_release_tpu_torch"
    dev = "" if pkg == "jax" else "device='cpu'"
    env = subprocess_env(OMPITPU_MCA_runtime_timing="1")
    r = subprocess.run(
        [sys.executable, "-c",
         f"import {mod} as mpi; mpi.init({dev}); mpi.finalize()"],
        env=env, capture_output=True, text=True, timeout=300,
        cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    assert r.returncode == 0, r.stderr
    assert "init timing (total" in r.stderr, r.stderr
    for stage in ("INIT", "ALLOCATE", "MAP", "VM_READY", "RUNNING"):
        assert stage in r.stderr, r.stderr


def test_init_timing_is_off_by_default(capfd):
    trt._reset_for_tests()
    try:
        tmpi.init(device="cpu")
        assert tvar.get("runtime_timing") is False
    finally:
        trt._reset_for_tests()
    assert "init timing" not in capfd.readouterr().err


# ---------------------------------------------------------------------------
# MPI_T (tests/test_observability.py's pvar sessions, and cvar handles)
# ---------------------------------------------------------------------------

@both
def test_counter_session_delta_and_reset(pkg, fresh):
    c = fresh["pvar"].counter("hits")
    c.add(5)
    sess = fresh["mpit"].Mpit().pvar_session()
    h = sess.handle("hits")
    assert h.read() == 5.0          # absolute before start
    h.start()
    c.add(2)
    assert h.read() == 2.0          # session-relative
    h.reset()                       # rebase within the session
    assert h.read() == 0.0
    c.add(1)
    assert h.read() == 1.0
    h.stop()
    assert h.read() == 8.0          # absolute again after stop
    sess.free()
    with pytest.raises(fresh["error"]):
        sess.handle("hits")         # closed session refuses handles


@both
def test_histogram_session_delta(pkg, fresh):
    hist = fresh["pvar"].histogram("lat")
    hist.observe(1.0)
    hist.observe(2.0)
    sess = fresh["mpit"].Mpit().pvar_session()
    h = sess.handle("lat")
    h.start()
    hist.observe(4.0)
    d = h.read()
    assert d["count"] == 1.0 and d["sum"] == 4.0
    assert sum(d["buckets"].values()) == 1.0
    assert d["max"] == 4.0  # extrema pass through as current values
    sess.free()


@both
def test_aggregate_session_delta(pkg, fresh):
    agg = fresh["pvar"].aggregate("skew")
    agg.observe(10.0)
    sess = fresh["mpit"].Mpit().pvar_session()
    h = sess.handle("skew")
    h.start()
    agg.observe(2.0)
    agg.observe(6.0)
    d = h.read()
    assert d["count"] == 2.0 and d["sum"] == 8.0


@both
def test_unknown_pvar_raises(pkg, fresh):
    sess = fresh["mpit"].Mpit().pvar_session()
    with pytest.raises(fresh["error"]):
        sess.handle("no_such_pvar")


@both
def test_cvar_handles_read_write_and_index(pkg, fresh):
    fresh["var"].register("coll_knob", "int", 3, "a knob")
    fresh["pvar"].counter("seen").add(2)
    t = fresh["mpit"].Mpit()
    assert t.cvar_get_num() == 1
    assert t.cvar_get_info(0)["name"] == "coll_knob"
    h = t.cvar_handle("coll_knob")
    assert h.name == "coll_knob" and h.read() == 3
    h.write(7)
    assert t.cvar_handle(0).read() == 7 and fresh["var"].get("coll_knob") == 7
    assert h.info()["name"] == "coll_knob"
    with pytest.raises(fresh["error"]):
        t.cvar_handle("no_such_cvar")
    assert t.pvar_get_num() == 1 and t.pvar_names() == ["seen"]


def test_mpit_reads_the_same_as_jax_on_the_same_calls(monkeypatch):
    """One script of registrations, observations and session reads on
    both packages gives the same reads."""
    reads = {}
    for name, m in PKGS.items():
        monkeypatch.setattr(m["var"], "VARS", m["var"].VarRegistry())
        monkeypatch.setattr(m["pvar"], "PVARS", m["pvar"].PvarRegistry())
        m["var"].register("k", "int", 1)
        c = m["pvar"].counter("c")
        hw = m["pvar"].highwatermark("hw")
        agg = m["pvar"].aggregate("agg")
        t = m["mpit"].Mpit()
        sess = t.pvar_session()
        hs = [sess.handle(n) for n in ("c", "hw", "agg")]
        out = [h.read() for h in hs]
        for h in hs:
            h.start()
        c.add(3)
        hw.set(9)
        hw.set(4)
        agg.observe(1.5)
        out += [h.read() for h in hs]
        t.cvar_handle("k").write(5)
        out += [t.cvar_handle(0).read(), t.cvar_get_num(), t.pvar_names()]
        reads[name] = out
    assert reads["torch"] == reads["jax"]
