"""Runtime, configuration and communicator layers of the PyTorch port,
held against the JAX package where both have the same function.

Fixtures are local: the port's registries are its own, and each test
that brings the runtime up resets it afterwards.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from ompi_release_tpu.comm.group import Group as JGroup
from ompi_release_tpu.mca import component as jcomponent
from ompi_release_tpu.mca.var import VarRegistry as JVarRegistry
from ompi_release_tpu.runtime.mesh import factorize_torus as j_factorize
import ompi_release_tpu_torch as tmpi
from ompi_release_tpu_torch.comm import communicator as tcomm
from ompi_release_tpu_torch.comm.group import Group as TGroup
from ompi_release_tpu_torch.mca import component as tcomponent
from ompi_release_tpu_torch.mca import var as tvar
from ompi_release_tpu_torch.mca.var import VarRegistry as TVarRegistry
from ompi_release_tpu_torch.runtime import runtime as trt
from ompi_release_tpu_torch.runtime.mesh import factorize_torus
from ompi_release_tpu_torch.runtime.state import JobState
from ompi_release_tpu_torch.utils import errors as terrors
from ompi_release_tpu_torch.utils.errors import ErrorCode, MPIError

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "ompi_release_tpu_torch"


@pytest.fixture
def fresh_runtime():
    """A runtime torn down before and after the test; the virtual-rank
    override is dropped with it."""
    trt._reset_for_tests()
    yield
    trt._reset_for_tests()
    tvar.VARS.unset("runtime_virtual_ranks")


def _cpu_world(n=8):
    return tmpi.init(cli_args=["--mca", "runtime_virtual_ranks", str(n)],
                     device="cpu")


# ---------------------------------------------------------------------------
# purity: no JAX, nothing of the JAX package
# ---------------------------------------------------------------------------

def _port_files():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_sources_import_no_jax(path):
    """Static check: the full top-level module name of every import —
    ``ompi_release_tpu_torch`` shares a prefix with ``ompi_release_tpu``,
    so a prefix test would be wrong."""
    banned = {"jax", "jaxlib", "ompi_release_tpu"}
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops = [(node.module or "").split(".")[0]]
        else:
            continue
        assert not banned & set(tops), (path, node.lineno, tops)


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ompi_release_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib',\n"
        "                                    'ompi_release_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules\n"
        "                 if m.startswith('ompi_release_tpu_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok ") and int(res.stdout.split()[1]) > 15


# ---------------------------------------------------------------------------
# device selection
# ---------------------------------------------------------------------------

def test_init_without_device_raises_without_cuda(fresh_runtime):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: init() would succeed")
    with pytest.raises(MPIError) as e:
        tmpi.init()
    assert e.value.code == ErrorCode.ERR_NOT_AVAILABLE
    assert "cuda" in str(e.value) and "device='cpu'" in str(e.value)
    assert not tmpi.initialized()


def test_cpu_world_with_virtual_ranks(fresh_runtime):
    world = _cpu_world(8)
    assert world.size == 8 and world.device == torch.device("cpu")
    rt = trt.Runtime.current()
    assert [e.rank for e in rt.endpoints] == list(range(8))
    assert {e.platform for e in rt.endpoints} == {"cpu"}
    assert rt.mesh.shape == (8,)
    assert rt.job_state.visited(JobState.REGISTERED)
    assert tmpi.initialized() and tmpi.init() is world  # idempotent


def test_cpu_world_defaults_to_one_rank_per_device(fresh_runtime):
    world = tmpi.init(device="cpu")
    assert world.size == 1
    assert world._coll_providers["allreduce"][0] == "self"


def test_mesh_shape_cvar(fresh_runtime):
    tvar.set_value("rmaps_mesh_shape", "4,2")
    try:
        _cpu_world(8)
        assert trt.Runtime.current().mesh.shape == (4, 2)
    finally:
        tvar.VARS.unset("rmaps_mesh_shape")


def test_reinit_after_finalize_raises(fresh_runtime):
    _cpu_world(2)
    tmpi.finalize()
    with pytest.raises(MPIError):
        _cpu_world(2)


@pytest.mark.parametrize("n,nd", [(8, 2), (12, 3), (7, 2), (64, 3), (1, 2)])
def test_factorize_torus_matches_jax(n, nd):
    assert factorize_torus(n, nd) == j_factorize(n, nd)


# ---------------------------------------------------------------------------
# one configuration drives both packages
# ---------------------------------------------------------------------------

def test_env_var_drives_both_registries(monkeypatch):
    monkeypatch.setenv("OMPITPU_MCA_coll_tuned_allreduce_algorithm", "ring")
    monkeypatch.setenv("OMPITPU_MCA_coll_tuned_segment_size", "256K")
    choices = ("auto", "ring", "recursive_doubling")
    for reg in (JVarRegistry(), TVarRegistry()):
        v = reg.register("coll_tuned_allreduce_algorithm", "enum", "auto",
                         choices=choices)
        s = reg.register("coll_tuned_segment_size", "size", 1 << 20)
        assert (v.value, v.source.name) == ("ring", "ENV")
        assert s.value == 256 << 10


def test_param_file_drives_both_registries(tmp_path):
    f = tmp_path / "mca-params.conf"
    f.write_text("# tuning\nop_threshold = 1M\ncoll = tuned,basic\n")
    for reg in (JVarRegistry(), TVarRegistry()):
        assert reg.load_param_file(str(f)) == 2
        assert reg.register("op_threshold", "size", 0).value == 1 << 20
        assert reg.register("coll", "list", "").value == ["tuned", "basic"]


def test_bad_env_value_names_the_variable(monkeypatch):
    monkeypatch.setenv("OMPITPU_MCA_some_int", "twelve")
    with pytest.raises(ValueError, match="some_int"):
        TVarRegistry().register("some_int", "int", 0)


def test_framework_include_exclude():
    """Framework select with include and ^exclude lists, in the port's
    own framework table, behaves like the JAX package's."""
    from ompi_release_tpu.mca import var as jvar

    results = []
    for comp_mod, reg in ((tcomponent, tvar.VARS), (jcomponent, jvar.VARS)):
        fw = comp_mod.Framework("torchtestfw")

        class A(comp_mod.Component):
            NAME, PRIORITY = "a", 30

        class B(comp_mod.Component):
            NAME, PRIORITY = "b", 20

        fw.register(A())
        fw.register(B())
        picks = [fw.select().NAME]
        try:
            reg.set_value("torchtestfw", "^a")
            picks.append(fw.select().NAME)
            reg.set_value("torchtestfw", "b,a")
            picks.append([c.NAME for _, c, _ in fw.available()])
        finally:
            reg.unset("torchtestfw")
        results.append(picks)
    assert results[0] == results[1] == ["a", "b", ["a", "b"]]


def test_port_registry_is_separate():
    from ompi_release_tpu.mca import var as jvar

    tvar.set_value("torch_only_probe", "1")
    try:
        assert jvar.get("torch_only_probe") is None
        assert "torch_only_probe" not in jvar.VARS._overrides
    finally:
        tvar.VARS.unset("torch_only_probe")


# ---------------------------------------------------------------------------
# groups and communicators
# ---------------------------------------------------------------------------

def test_group_calculus_matches_jax():
    for G in (TGroup, JGroup):
        g = G(range(8))
        h = g.incl([7, 1, 3])
        assert h.world_ranks == (7, 1, 3)
    tg, jg = TGroup(range(8)), JGroup(range(8))
    ops = [
        lambda g: g.excl([0, 2]).world_ranks,
        lambda g: g.range_incl([(6, 0, -3)]).world_ranks,
        lambda g: g.incl([1, 2]).union(g.incl([2, 5])).world_ranks,
        lambda g: g.incl([1, 2, 3]).intersection(g.incl([3, 1])).world_ranks,
        lambda g: g.translate_ranks([0, 1], g.incl([1, 0])),
        lambda g: g.compare(g.incl(list(range(7, -1, -1)))),
    ]
    for op in ops:
        assert op(tg) == op(jg)


def test_dup_split_free_and_attributes(fresh_runtime):
    world = _cpu_world(8)
    copies = []
    kv = tcomm.create_keyval(
        copy_fn=lambda c, k, v, s: (True, v + 1),
        delete_fn=lambda c, k, v, s: copies.append(v))
    world.set_attr(kv, 10)
    d = world.dup()
    assert d.get_attr(kv) == (True, 11) and d.cid != world.cid
    d.free()
    assert copies == [11]
    with pytest.raises(MPIError) as e:
        d.allreduce(torch.ones(8, 2))
    assert e.value.code == ErrorCode.ERR_COMM
    parts = world.split([0, 0, 1, 1, 0, 1, -1, 0])
    assert parts[6] is None and parts[0].size == 4 and parts[2].size == 3
    sub = world.create(world.group.incl([1, 3]))
    assert sub.size == 2 and sub.group.world_ranks == (1, 3)
    assert world.create(world.group.incl([])) is None
    tcomm.free_keyval(kv)


def test_errhandlers(fresh_runtime):
    world = _cpu_world(2)
    seen = []
    world.set_errhandler(terrors.Errhandler(lambda c, e: seen.append(e.code)))
    world.call_errhandler(MPIError(ErrorCode.ERR_ARG, "x"))
    assert seen == [ErrorCode.ERR_ARG]
    world.set_errhandler(terrors.ERRORS_RETURN)
    with pytest.raises(MPIError):
        world.call_errhandler(MPIError(ErrorCode.ERR_ARG, "x"))
    world.set_errhandler(terrors.ERRORS_ARE_FATAL)
    with pytest.raises(SystemExit):
        world.call_errhandler(MPIError(ErrorCode.ERR_ARG, "x"))


def test_error_codes_match_jax():
    from ompi_release_tpu.utils.errors import ErrorCode as JErrorCode

    assert {e.name: int(e) for e in ErrorCode} == \
        {e.name: int(e) for e in JErrorCode}
    assert tmpi.error_string(2) == "ERR_COUNT"


# ---------------------------------------------------------------------------
# dynamic rule files: one file, the same picks in both packages
# ---------------------------------------------------------------------------

def test_rule_file_picks_like_jax(tmp_path):
    from ompi_release_tpu.coll import components as jcomponents
    from ompi_release_tpu.coll import dynamic_rules as jrules
    from ompi_release_tpu.mca import var as jvar
    from ompi_release_tpu_torch.coll import components as tcomponents
    from ompi_release_tpu_torch.coll import dynamic_rules as trules

    for fw in (jcomponents.COLL_FRAMEWORK, tcomponents.COLL_FRAMEWORK):
        fw.open()  # registers the tuned cvars the rules read

    f = tmp_path / "rules.txt"
    f.write_text("allreduce 0 0 recursive_doubling\n"
                 "allreduce 0 4096 ring 64K\n"
                 "allreduce 16 0 auto\n"
                 "alltoall 4 0 pairwise\n")
    kv = {"coll_tuned_use_dynamic_rules": "1",
          "coll_tuned_dynamic_rules_filename": str(f)}
    for k, v in kv.items():
        jvar.set_value(k, v)
        tvar.set_value(k, v)
    try:
        for coll, n, nbytes in (("allreduce", 8, 100),
                                ("allreduce", 8, 8192),
                                ("allreduce", 16, 8192),
                                ("alltoall", 2, 10), ("alltoall", 8, 10),
                                ("bcast", 8, 10)):
            assert trules.lookup(coll, n, nbytes) == \
                jrules.lookup(coll, n, nbytes)
            assert trules.lookup_segsize(coll, n, nbytes) == \
                jrules.lookup_segsize(coll, n, nbytes)
        f.write_text("# fingerprint: hosts=1;ppn=8;links=shm;P=8\n"
                     "allreduce 0 0 ring\n")
        with pytest.raises(MPIError, match="not ported") as e:
            trules.lookup("allreduce", 8, 100)
        assert e.value.code == ErrorCode.ERR_NOT_AVAILABLE
        f.write_text("allreduce 0 0 warp_drive\n")
        with pytest.raises(MPIError, match="rules.txt:1"):
            trules.lookup("allreduce", 8, 100)
    finally:
        for k in kv:
            jvar.VARS.unset(k)
            tvar.VARS.unset(k)


def test_forced_algorithm_wins_over_size_rules(fresh_runtime):
    world = _cpu_world(8)
    tvar.set_value("coll", "tuned")
    try:
        c = world.dup()
    finally:
        tvar.VARS.unset("coll")
    tvar.set_value("coll_tuned_allreduce_algorithm", "basic_linear")
    try:
        c.allreduce(torch.ones(8, 4))
    finally:
        tvar.VARS.unset("coll_tuned_allreduce_algorithm")
    assert ("tuned", "allreduce", "basic_linear") == \
        next(iter(c._coll_programs))[:3]
