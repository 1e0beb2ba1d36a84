"""The port's spanning jobs beyond the collectives held against the JAX
package: the dropless MoE, two-phase collective IO and intercommunicators
on a world of 2 workers x 4 ranks, the tree job of 3 workers, and the
port bench's ``tree`` suite.

The parity jobs (the harness of ``tests/test_torch_unified_world.py``:
one app body through both packages' ``Job``, the workers' npz dumps
compared bitwise) cover ``tests/test_unified_world.py``'s
``test_dropless_moe_on_spanning_world`` (``:367``),
``test_cross_process_collective_io_two_phase`` (``:721``: the files both
packages write are compared byte for byte too) and
``test_intercomm_across_processes`` (``:1060``), and ``TestTreeJob`` of
``tests/test_tree.py`` (``:582``, app ``:497-575``): the planned
whole-tree pass under the progress thread with both hidden-seconds pvars
> 0 and bitwise the per-leaf allreduce, and ``pp.HostPipeline`` across
process boundaries, its nonblocking leg bitwise the blocking one. The
tree suite's lines carry ``bench.py``'s ``_tree_micro_suite`` names.
"""

import re

import numpy as np
import pytest
import torch

import bench as jbench
from ompi_release_tpu_torch import bench as tbench

from test_torch_unified_world import _assert_bitwise_each, _parity

SPAN_BODY = """
import importlib
OUT = {}
MOD = "ompi_release_tpu" if PKG == "jax" else "ompi_release_tpu_torch"
ep = importlib.import_module(MOD + ".parallel.ep")
fmod = importlib.import_module(MOD + ".io.file")
dt = importlib.import_module(MOD + ".datatype.datatype")
icm = importlib.import_module(MOD + ".comm.intercomm")
world = init()
rt = Runtime.current()
off = rt.local_rank_offset
n = world.size
DUMP = os.environ["PARITY_DUMP"]

# -- the dropless MoE (test_unified_world.py:367) -----------------------
n_experts, d = 16, 4
rng = np.random.RandomState(0)
all_tokens = [rng.randn(3 + r, d).astype(np.float32) for r in range(n)]
all_assign = [rng.randint(0, n_experts, size=(3 + r,)) for r in range(n)]

def expert_fn(e, x):
    return x * (e + 1)

outs = ep.dropless_moe(world, all_tokens[off:off + 4],
                       all_assign[off:off + 4], expert_fn, n_experts)
for i in range(4):
    r = off + i
    OUT[f"moe_{i}"] = npy(outs[i])
    want = all_tokens[r] * (all_assign[r][:, None] + 1)
    np.testing.assert_allclose(OUT[f"moe_{i}"], want, rtol=1e-6)
world.barrier()

# -- two-phase collective IO (test_unified_world.py:721) ----------------
path = os.path.join(DUMP, PKG + "-out.bin")
f = fmod.File(world, path)
f.set_view(etype=np.int32)
offs = [(off + i) * 5 for i in range(4)]
blocks = [100 * (off + i) + np.arange(5, dtype=np.int32) for i in range(4)]
OUT["io_total"] = np.int64(f.write_at_all(offs, blocks))
got = f.read_at_all(offs, [5] * 4)
for i in range(4):
    OUT[f"io_read_{i}"] = np.asarray(got[i])
    np.testing.assert_array_equal(got[i], blocks[i])
req = f.iwrite_at_all(offs, blocks)
req.wait()
req = f.iread_at_all(offs, [5] * 4)
req.wait()
for i in range(4):
    OUT[f"io_iread_{i}"] = np.asarray(req.value[i])
f.close()
world.barrier()
path2 = os.path.join(DUMP, PKG + "-out.bin.holey")
f2 = fmod.File(world, path2)
ft = dt.create_vector(2, 2, 4, dt.INT32)
f2.set_view(0, np.int32, filetype=ft)
offs2 = [(off + i) * 4 for i in range(4)]
blocks2 = [1000 * (off + i) + np.arange(4, dtype=np.int32)
           for i in range(4)]
f2.write_at_all(offs2, blocks2)
got2 = f2.read_at_all(offs2, [4] * 4)
for i in range(4):
    OUT[f"io_holey_{i}"] = np.asarray(got2[i])
    np.testing.assert_array_equal(got2[i], blocks2[i])
f2.close()
world.barrier()

# -- an intercommunicator across processes (test_unified_world.py:1060) -
subs = world.split([0] * 4 + [1] * 4)
ia, ib = icm.intercomm_create(subs[0], 0, subs[4], 0)
inter = ia if off == 0 else ib
assert inter.remote_size == 4
if off == 0:
    inter.send(np.int32([41]), dest=2, tag=3, rank=1)
    val, st = inter.recv(source=2, tag=4, rank=1)
    OUT["inter_recv"] = npy(val)
    OUT["inter_source"] = np.int32(st.source)
else:
    val, st = inter.recv(source=1, tag=3, rank=2)
    OUT["inter_recv"] = npy(val)
    OUT["inter_source"] = np.int32(st.source)
    inter.send(np.int32([42]), dest=1, tag=4, rank=2)
merged = inter.merge(high=(off == 4))
assert merged.size == n and merged.spans_processes
x = np.stack([np.int32([off + i]) for i in range(4)])
OUT["inter_merged_allreduce"] = npy(merged.allreduce(x))
assert (OUT["inter_merged_allreduce"] == sum(range(n))).all()
world.barrier()
mpi.finalize()
"""


@pytest.fixture(scope="module")
def span(tmp_path_factory):
    return _parity(tmp_path_factory, SPAN_BODY, "spanning_jobs")


@pytest.mark.parametrize("case", ["moe", "io", "inter"])
def test_spanning_parity(span, case):
    _assert_bitwise_each(span, case + "_")


def test_two_phase_files_byte_identical(span, tmp_path_factory):
    """Both packages' files (contiguous and through a holey vector view)
    are the same bytes, and the contiguous one is the single-process
    closed form: rank r's 5 elements 100 r + k at element r * 5."""
    import glob
    import os

    dumps = sorted(glob.glob(os.path.join(
        str(tmp_path_factory.getbasetemp()), "spanning_jobs*", "dump")))
    assert dumps
    d = dumps[-1]
    for name in ("out.bin", "out.bin.holey"):
        with open(os.path.join(d, "jax-" + name), "rb") as fj, \
                open(os.path.join(d, "torch-" + name), "rb") as ft:
            assert fj.read() == ft.read(), name
    ref = np.concatenate([100 * r + np.arange(5, dtype=np.int32)
                          for r in range(8)])
    got = np.fromfile(os.path.join(d, "torch-out.bin"), dtype=np.int32)
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# TestTreeJob (tests/test_tree.py:497-582): 3 workers x 1 rank
# ---------------------------------------------------------------------------

TREE_BODY = """
import importlib, time
OUT = {}
MOD = "ompi_release_tpu" if PKG == "jax" else "ompi_release_tpu_torch"
pp_mod = importlib.import_module(MOD + ".parallel.pp")
tree_mod = importlib.import_module(MOD + ".parallel.tree")

def _pv(name):
    p = pvar.PVARS.lookup(name)
    return float(p.read()) if p is not None else 0.0

world = init()
rt = Runtime.current()
me = rt.bootstrap["process_index"]
ln = len(world.local_comm_ranks)
off = rt.local_rank_offset
n = world.size

grads = {"w%d" % k: np.stack(
             [np.arange(12000, dtype=np.float32) * (off + i + k + 1)
              for i in range(ln)])
         for k in range(6)}
sync = tree_mod.TreeSync(world, mean=False, bucket_bytes=1 << 20)
sync.issue(grads).wait()

mca_var.set_value("progress_thread", True)
world.barrier()
h0 = _pv("nbc_hidden_seconds")
t0 = _pv("tree_hidden_seconds")
pending = sync.issue(grads)
t_end = time.perf_counter() + 0.5
a = np.ones((64, 64), np.float32)
while time.perf_counter() < t_end:
    a = a @ a * 1e-4
out = pending.wait()
hidden_nbc = _pv("nbc_hidden_seconds") - h0
hidden_tree = _pv("tree_hidden_seconds") - t0
mca_var.VARS.unset("progress_thread")
assert hidden_nbc > 0, hidden_nbc
assert hidden_tree > 0, hidden_tree
for k in sorted(grads):
    ref = npy(world.allreduce(grads[k]))
    OUT["tree_" + k] = npy(out[k])
    assert OUT["tree_" + k].tobytes() == ref.tobytes(), k

W = np.eye(32, dtype=np.float32) * 0.5
mbs = [np.ones((8, 32), np.float32) * (k + 1) for k in range(5)]
outs = {}
for leg, nb in (("nb", True), ("bl", False)):
    pipe = pp_mod.HostPipeline(world, lambda x: npy(x) @ W, stage=me,
                               nonblocking=nb)
    world.barrier()
    outs[leg] = pipe.run(mbs)
    world.barrier()
if me == n - 1:
    assert len(outs["nb"]) == 5
    for k, (a_, b_) in enumerate(zip(outs["nb"], outs["bl"])):
        OUT[f"pp_{k}"] = npy(a_)
        assert npy(a_).tobytes() == npy(b_).tobytes()
        ref = np.ones((8, 32), np.float32) * (k + 1)
        for _ in range(n):
            ref = ref @ W
        np.testing.assert_array_equal(npy(a_), ref)
world.barrier()
mpi.finalize()
"""


def test_tree_job_parity(tmp_path_factory):
    """3 workers, one rank each, every worker its own host identity (the
    DCN path, as the JAX test runs it): the overlapped planned pass
    hides comm under the progress thread (both hidden-seconds pvars > 0,
    asserted in-app), bitwise the per-leaf allreduce; HostPipeline's
    nonblocking leg bitwise its blocking leg and the closed form; every
    value bitwise the JAX package's."""
    body = ('os.environ["OMPITPU_HOST_ID"] = '
            '"treejob-" + os.environ["OMPITPU_NODE_ID"]\n' + TREE_BODY)
    dumps = _parity(tmp_path_factory, body, "tree_job", n=3, nvirt=1)
    _assert_bitwise_each(dumps, "tree_")
    _assert_bitwise_each(dumps, "pp_")


# ---------------------------------------------------------------------------
# the bench's tree suite
# ---------------------------------------------------------------------------

def _reference_tree_names():
    """The metric names bench.py's ``_tree_micro_suite`` app writes, in
    order (read off its worker app: the suite itself runs a JAX job)."""
    src = jbench._TREE_BENCH_APP
    names = re.findall(r'"metric": "([a-z_]+)"( \+ suffix)?', src)
    out = []
    for name, suffixed in names:
        if suffixed:
            out += [name, name + "_polling"]
        else:
            out.append(name)
    return out


def test_tree_suite_lines_match_bench_py():
    lines = tbench.tree_suite(torch.device("cpu"), small=True)
    assert [ln["metric"] for ln in lines] == _reference_tree_names() == [
        "tree_planned_pass_speedup", "tree_allreduce_hidden_frac",
        "tree_allreduce_hidden_frac_polling", "tree_overlap_speedup",
        "tree_pp_overlap_speedup", "tree_overlap_pvars"]
    by = {ln["metric"]: ln for ln in lines}
    assert by["tree_planned_pass_speedup"]["value"] > 0
    assert by["tree_allreduce_hidden_frac_polling"]["value"] == 0.0
    assert 0.0 <= by["tree_allreduce_hidden_frac"]["value"] <= 1.0
    assert by["tree_pp_overlap_speedup"]["stages"] == 3
    for ln in lines:
        assert ln["suite"] == "tree_overlap"
