"""File IO, sharded arrays, checkpoints and the memchecker of the PyTorch
port (``io/file.py``, ``io/sharded.py``, ``ft/checkpoint.py``,
``utils/memchecker.py``) held against the JAX package.

The cases of ``tests/test_io_ft.py`` (``TestShardedIO``,
``TestFileAPI``, ``TestFiletypeViews``, ``TestNonblockingIO``,
``TestCheckpoint``, ``TestFlatLayout``, ``TestMemchecker`` and the
shared-pointer case) run as one script on both packages, each in its own
directory, with the same seeded numpy inputs. What each observes must be
equal BITWISE, and the files each writes must be the same bytes: every
``.npy`` shard, every manifest (crc32 included), every raw MPI-IO file.
Three fields may differ and are left out of the byte comparison: a
checkpoint's ``meta.json`` ``time``, a gzip shard's header time (the
shard is compared decompressed), and ``pytree.json``'s ``treedef``
string (JAX's ``str(PyTreeDef)`` against the port's rendering of the
same tree; its leaf count and version are compared). Added here: a
checkpoint and a sharded array written by either package restore in
the other, leaves numbered in ``jax.tree.flatten``'s order (sorted dict
keys); an asynchronous save of state that is then updated in place
restores the state as it was at the save (the port's tensors are
mutable, JAX's arrays are not); the memchecker's donation counterpart.
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ompi_release_tpu as jmpi
from ompi_release_tpu import io as jio
from ompi_release_tpu.datatype import datatype as jdt
from ompi_release_tpu.ft.checkpoint import Checkpointer as JCheckpointer
from ompi_release_tpu.io import sharded as jsharded
from ompi_release_tpu.mca import var as jvar
from ompi_release_tpu.utils import memchecker as jmem
from ompi_release_tpu.utils.errors import MPIError as JMPIError
import ompi_release_tpu_torch as tmpi
from ompi_release_tpu_torch import io as tio
from ompi_release_tpu_torch.datatype import datatype as tdt
from ompi_release_tpu_torch.ft import Checkpointer as TCheckpointer
from ompi_release_tpu_torch.io import sharded as tsharded
from ompi_release_tpu_torch.mca import pvar as tpvar
from ompi_release_tpu_torch.mca import var as tvar
from ompi_release_tpu_torch.runtime import runtime as trt
from ompi_release_tpu_torch.utils import memchecker as tmem
from ompi_release_tpu_torch.utils import pytree as tpytree
from ompi_release_tpu_torch.utils.errors import MPIError as TMPIError

N = 8


@pytest.fixture(scope="module")
def worlds():
    jworld = jmpi.init()
    trt._reset_for_tests()
    tworld = tmpi.init(cli_args=["--mca", "runtime_virtual_ranks", str(N)],
                       device="cpu")
    yield jworld, tworld
    trt._reset_for_tests()
    tvar.VARS.unset("runtime_virtual_ranks")


class Side:
    def __init__(self, name, world):
        jax_ = name == "jax"
        self.name, self.world = name, world
        self.io = jio if jax_ else tio
        self.sharded = jsharded if jax_ else tsharded
        self.dt = jdt if jax_ else tdt
        self.Checkpointer = JCheckpointer if jax_ else TCheckpointer
        self.var = jvar if jax_ else tvar
        self.Error = JMPIError if jax_ else TMPIError
        self.bf16 = jnp.bfloat16 if jax_ else torch.bfloat16

    def array(self, x, dtype=None):
        """The package's own array of a numpy value."""
        if self.name == "jax":
            return jnp.asarray(x, dtype)
        t = torch.from_numpy(np.ascontiguousarray(x))
        return t if dtype is None else t.to(dtype)


def obs(v):
    if isinstance(v, torch.Tensor):
        if v.dtype is torch.bfloat16:
            return v.view(torch.int16).numpy()
        return v.detach().cpu().numpy()
    if hasattr(v, "dtype") and hasattr(v, "shape"):
        a = np.asarray(v)
        return a.view(np.int16) if a.dtype.name == "bfloat16" else a
    if isinstance(v, dict):
        return {k: obs(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [obs(x) for x in v]
    return v


def same(a, b):
    a, b = obs(a), obs(b)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    return a == b


def raises(S, fn):
    try:
        fn()
    except S.Error as e:
        return ("raised", e.code.name)
    return None


def tree_files(root):
    """{relative path: bytes} of every file under ``root``, with the
    fields that may differ taken out (checkpoint time, treedef, a gzip
    header's time)."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            raw = open(p, "rb").read()
            if raw[:2] == b"\x1f\x8b":  # gzip: its header holds a time
                raw = gzip.decompress(raw)
            if f in ("meta.json", "pytree.json"):
                meta = json.loads(raw)
                meta.pop("time", None)
                meta.pop("treedef", None)
                raw = json.dumps(meta, sort_keys=True).encode()
            out[os.path.relpath(p, root)] = raw
    return out


def both(worlds, tmp_path, script):
    """Run ``script(S, dir)`` on both packages; the observations and the
    files written must be equal."""
    outs, files = [], []
    for name, world in zip(("jax", "torch"), worlds):
        d = tmp_path / name
        d.mkdir(parents=True)
        outs.append(script(Side(name, world), str(d)))
        files.append(tree_files(str(d)))
    j, t = outs
    assert same(j, t), (obs(j), obs(t))
    assert files[0].keys() == files[1].keys(), (sorted(files[0]),
                                                sorted(files[1]))
    for k in files[0]:
        assert files[0][k] == files[1][k], k
    return j, t, files[1]


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# TestShardedIO / TestFlatLayout
# ---------------------------------------------------------------------------

def sc_sharded_roundtrip(S, d):
    x = np.random.RandomState(0).randn(8, 16, 4).astype(np.float32)
    S.sharded.save_sharded(d, S.array(x), name="w")
    return [S.sharded.load_sharded(d, name="w"),
            sorted(f for f in os.listdir(d) if f.endswith(".npy"))]


def sc_sharded_async(S, d):
    x = _rng(1).standard_normal((4, 1000)).astype(np.float32)
    futs = S.sharded.save_sharded(d, S.array(x), name="a", async_=True)
    for f in futs:
        f.result()
    return [S.sharded.load_sharded(d, name="a")]


def sc_sharded_bf16(S, d):
    x = np.random.RandomState(1).randn(4, 8).astype(np.float32)
    S.sharded.save_sharded(d, S.array(x, S.bf16), name="b")
    y = S.sharded.load_sharded(d, name="b")
    return [y, str(y.dtype).replace("torch.", "")]


def sc_sharded_int_and_gzip(S, d):
    x = _rng(3).integers(-2**31, 2**31 - 1, (6, 33)).astype(np.int32)
    S.var.set_value("io_compress", "gzip")
    try:
        S.sharded.save_sharded(d, S.array(x), name="g", layout="flat",
                               num_shards=4)
    finally:
        S.var.VARS.unset("io_compress")
    return [S.sharded.load_sharded(d, name="g")]


def sc_pytree_roundtrip(S, d):
    tree = {
        "w": np.random.RandomState(2).randn(4, 3).astype(np.float32),
        "b": np.float32(2.5),  # scalar leaf
        "nested": {"i": np.arange(6, dtype=np.int32)},
    }
    S.sharded.save_pytree(d, tree)
    out = S.sharded.load_pytree(d, tree)
    return [out["w"], float(out["b"]), out["nested"]["i"]]


def sc_missing_manifest(S, d):
    return [raises(S, lambda: S.sharded.load_sharded(d, name="nope"))]


def sc_corrupt_shard(S, d):
    S.sharded.save_sharded(d, S.array(np.arange(8, dtype=np.float32)
                                      .reshape(2, 4)), name="c")
    p = os.path.join(d, "c.shard00001.npy")
    raw = bytearray(open(p, "rb").read())
    raw[-1] ^= 0xFF
    open(p, "wb").write(bytes(raw))
    return [raises(S, lambda: S.sharded.load_sharded(d, name="c"))]


def sc_flat_shard_count(S, d):
    x = np.arange(4096 * 8, dtype=np.float32).reshape(4096, 8)
    S.var.set_value("io_target_shard_bytes", 32 * 1024)
    try:
        S.sharded.save_sharded(d, S.array(x), name="flat", layout="flat")
    finally:
        S.var.VARS.unset("io_target_shard_bytes")
    shards = sorted(f for f in os.listdir(d) if f.startswith("flat.shard"))
    return [len(shards), S.sharded.load_sharded(d, name="flat")]


def sc_pytree_flat_layout(S, d):
    tree = {"embed": np.random.RandomState(0).randn(512, 4)
            .astype(np.float32), "scale": np.float32(2.5)}
    S.sharded.save_pytree(d, tree)
    shards = sorted(f for f in os.listdir(d) if ".shard" in f)
    out = S.sharded.load_pytree(d, tree)
    return [shards, out["embed"], float(out["scale"])]


# ---------------------------------------------------------------------------
# TestFileAPI / TestFiletypeViews / TestNonblockingIO / shared pointer
# ---------------------------------------------------------------------------

def sc_write_read_at_with_view(S, d):
    p = os.path.join(d, "f.bin")
    with S.io.File(S.world, p, S.io.MODE_RDWR | S.io.MODE_CREATE) as f:
        f.set_view(disp=8, etype=np.float32)
        n = f.write_at(2, np.array([1.5, 2.5], np.float32))
        out = f.read_at(2, 2)
        size = f.size()
    return [n, out, size]


def sc_collective_write_all(S, d):
    p = os.path.join(d, "c.bin")
    blocks = [_rng(r).standard_normal(4).astype(np.float32)
              for r in range(N)]
    with S.io.File(S.world, p) as f:
        f.set_view(etype=np.float32)
        n = f.write_at_all([r * 4 for r in range(N)], blocks)
        back = f.read_at_all([r * 4 for r in range(N)], [4] * N)
        whole = f.read_at(0, 4 * N)
    return [n, back, whole]


def sc_shared_pointer(S, d):
    p = os.path.join(d, "s.bin")
    with S.io.File(S.world, p) as f:
        f.set_view(etype=np.int32)
        f.write_ordered([np.array([r], np.int32) for r in range(N)])
        f._shared_ptr = 0
        out = [f.read_shared(N)]
        f._shared_ptr = 0
        out.append(f.read_ordered([1, 2, 3, 0, 4]))
    p = os.path.join(d, "sharedfp.bin")
    with S.io.File(S.world, p) as f:
        f.set_view(0, np.float32)
        out += [f.write_shared(np.arange(3, dtype=np.float32)),
                f.write_shared(np.full(2, 9.0, np.float32)),
                f.read_at(0, 5)]
    return out


def sc_vector_view_skips_holes(S, d):
    path = os.path.join(d, "v.bin")
    with S.io.File(S.world, path) as f:
        f.write_at(0, np.full(32, 0xEE, np.uint8))
    with S.io.File(S.world, path) as f:
        ft = S.dt.create_vector(4, 2, 4, S.dt.INT32)  # 2 data, 2 hole
        f.set_view(0, np.int32, filetype=ft)
        f.write_at(0, np.arange(8, dtype=np.int32))
        got = f.read_at(0, 8)
    return [got]


def sc_view_spans_tiles(S, d):
    with S.io.File(S.world, os.path.join(d, "t.bin")) as f:
        ft = S.dt.create_vector(2, 1, 2, S.dt.FLOAT)
        f.set_view(8, np.float32, filetype=ft)
        f.write_at(3, np.arange(3, 10, dtype=np.float32))
        got = f.read_at(3, 7)
    with S.io.File(S.world, os.path.join(d, "m.bin")) as f:
        ft = S.dt.create_vector(2, 1, 2, S.dt.INT64)
        err = raises(S, lambda: f.set_view(0, np.int32, filetype=ft))
    return [got, err]


def sc_nonblocking(S, d):
    out = []
    with S.io.File(S.world, os.path.join(d, "nb.bin")) as f:
        f.set_view(0, np.float32)
        wreq = f.iwrite_at(2, np.arange(16, dtype=np.float32))
        st = wreq.wait()
        out += [st.count, wreq.value]
        rreq = f.iread_at(2, 16)
        rreq.wait()
        out.append(rreq.value)
    # interleaved views written nonblockingly
    path = os.path.join(d, "ileave.bin")
    n = 8
    ft = S.dt.create_vector(n, 1, 2, S.dt.INT32)
    with S.io.File(S.world, path) as f:
        f.set_view(0, np.int32, filetype=ft)
        r0 = f.iwrite_at(0, np.arange(n, dtype=np.int32))
        f2 = S.io.File(S.world, path)
        f2.set_view(4, np.int32, filetype=ft)
        r1 = f2.iwrite_at(0, 100 + np.arange(n, dtype=np.int32))
        out += [r0.wait().count, r1.wait().count]
        rr = f.iread_at(0, n)
        rr.wait()
        out += [rr.value, f2.read_at(0, n)]
        f2.close()
    with S.io.File(S.world, os.path.join(d, "call.bin")) as f:
        f.set_view(0, np.int32)
        req = f.iwrite_at_all([r * 4 for r in range(N)],
                              [np.full(4, r, np.int32) for r in range(N)])
        req.wait()
        rq = f.iread_at_all([r * 4 for r in range(N)], [4] * N)
        rq.wait()
        out += [f.read_at(0, 4 * N), rq.value]
    f = S.io.File(S.world, os.path.join(d, "err.bin"))
    f.set_view(0, np.float32)
    f.close()
    out.append(raises(S, lambda: f.iwrite_at(0, np.ones(4, np.float32))))
    f = S.io.File(S.world, os.path.join(d, "drain.bin"))
    f.set_view(0, np.uint8)
    reqs = [f.iwrite_at(i * 1000, np.full(1000, i, np.uint8))
            for i in range(8)]
    f.close()  # must drain the pool
    out += [os.path.getsize(os.path.join(d, "drain.bin")),
            [r.wait().count for r in reqs]]
    return out


# ---------------------------------------------------------------------------
# TestCheckpoint
# ---------------------------------------------------------------------------

def sc_checkpoint_save_restore(S, d):
    ck = S.Checkpointer(d, comm=S.world)
    state = {"p": np.random.RandomState(3).randn(4, 4).astype(np.float32),
             "step": np.int32(7)}
    ck.save(7, state, async_=False)
    out = ck.restore(state)
    return [ck.steps(), out["p"], int(out["step"])]


def sc_checkpoint_async_gc(S, d):
    ck = S.Checkpointer(d, keep=2, comm=S.world)
    s = {"x": np.ones(8, np.float32)}
    for step in (1, 2, 3, 4):
        ck.save(step, {"x": s["x"] * step}, extra_meta={"loss": 1.0 / step})
    ck.wait()
    out = ck.restore(s, 3)
    return [ck.steps(), ck.latest_step(), out["x"], ck.meta(4)["loss"]]


def sc_checkpoint_uncommitted(S, d):
    ck = S.Checkpointer(d, comm=S.world)
    ck.save(1, {"x": np.ones(2, np.float32)}, async_=False)
    os.makedirs(os.path.join(d, "step_0000000002.tmp"))
    out = [ck.latest_step()]
    ck.abort()  # sweeps the stale tmp dir
    out.append(sorted(os.listdir(d)))
    return out


def sc_checkpoint_quiesce(S, d):
    ck = S.Checkpointer(d, comm=S.world)
    r = S.world.irecv(source=0, tag=4242, rank=1)
    out = [raises(S, lambda: ck.save(1, {"x": np.zeros(2, np.float32)}))]
    r.cancel()
    ck.save(1, {"x": np.zeros(2, np.float32)}, async_=False)
    out.append(ck.steps())
    return out


CASES = [sc_sharded_roundtrip, sc_sharded_async, sc_sharded_bf16,
         sc_sharded_int_and_gzip, sc_pytree_roundtrip, sc_missing_manifest,
         sc_corrupt_shard, sc_flat_shard_count, sc_pytree_flat_layout,
         sc_write_read_at_with_view, sc_collective_write_all,
         sc_shared_pointer, sc_vector_view_skips_holes, sc_view_spans_tiles,
         sc_nonblocking, sc_checkpoint_save_restore, sc_checkpoint_async_gc,
         sc_checkpoint_uncommitted, sc_checkpoint_quiesce]


@pytest.mark.parametrize("script", CASES, ids=lambda f: f.__name__[3:])
def test_io_case_matches_jax(worlds, tmp_path, script):
    both(worlds, tmp_path, script)


def test_closed_forms(worlds, tmp_path):
    """The JAX tests' own closed forms on the port's results."""
    world = worlds[1]
    _, t, files = both(worlds, tmp_path / "a", sc_flat_shard_count)
    assert t[0] == 4  # 128 KiB / 32 KiB
    _, t, _ = both(worlds, tmp_path / "b", sc_pytree_flat_layout)
    assert len(t[0]) == 2  # NOT 512 row files
    _, t, _ = both(worlds, tmp_path / "c", sc_vector_view_skips_holes)
    raw = np.fromfile(str(tmp_path / "c" / "torch" / "v.bin"), np.int32)
    np.testing.assert_array_equal(raw[[0, 1, 4, 5]], [0, 1, 2, 3])
    assert (np.frombuffer(raw[[2, 3]].tobytes(), np.uint8) == 0xEE).all()
    _, t, _ = both(worlds, tmp_path / "d", sc_checkpoint_async_gc)
    assert t[0] == [3, 4] and t[1] == 4
    assert obs(t[2]).tolist() == [3.0] * 8
    _, t, _ = both(worlds, tmp_path / "e", sc_sharded_bf16)
    assert t[1] == "bfloat16"
    assert world.size == N


# ---------------------------------------------------------------------------
# cross-package: files written by one package restore in the other
# ---------------------------------------------------------------------------

def _tree(S):
    rng = _rng(21)
    return {
        "zeta": S.array(rng.standard_normal((7, 5)).astype(np.float32)),
        "alpha": [S.array(rng.standard_normal(300).astype(np.float32),
                          S.bf16),
                  S.array(np.arange(12, dtype=np.int32).reshape(3, 4))],
        "mid": {"b": S.array(np.float32(1.25)), "a": None,
                "c": (S.array(rng.standard_normal((2, 2))
                              .astype(np.float32)),)},
    }


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_restores_across_packages(worlds, tmp_path, writer):
    """A checkpoint written by one package restores in the other, leaf
    for leaf and bit for bit; the shards and manifests are the same
    bytes either way."""
    sides = {n: Side(n, w) for n, w in zip(("jax", "torch"), worlds)}
    reader = "torch" if writer == "jax" else "jax"
    W, R = sides[writer], sides[reader]
    d = tmp_path / "ck"
    ck = W.Checkpointer(str(d), comm=W.world)
    ck.save(5, _tree(W), async_=False)
    got = R.Checkpointer(str(d), comm=R.world).restore(_tree(R))
    want = _tree(R)
    assert same(got["zeta"], want["zeta"])
    assert same(got["alpha"], want["alpha"])
    assert same(got["mid"]["b"], want["mid"]["b"])
    assert same(got["mid"]["c"][0], want["mid"]["c"][0])
    assert got["mid"]["a"] is None
    # and the bytes: the reader's own save of the same tree is identical
    d2 = tmp_path / "ck2"
    R.Checkpointer(str(d2), comm=R.world).save(5, _tree(R), async_=False)
    f1, f2 = tree_files(str(d)), tree_files(str(d2))
    assert f1 == f2


def test_leaf_order_follows_jax_tree_flatten():
    tree = {"zeta": 1, "alpha": [2, 3], "mid": {"b": 4, "a": None,
                                               "c": (5,)}}
    leaves, treedef = tpytree.flatten(tree)
    assert leaves == jax.tree.leaves(tree) == [2, 3, 4, 5, 1]
    assert tpytree.unflatten(treedef, leaves) == tree
    # the readable treedef may differ from JAX's str(PyTreeDef): it is
    # the one field of pytree.json the byte comparisons leave out
    assert tpytree.treedef_str(treedef).startswith("PyTreeDef(")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_sharded_array_restores_across_packages(worlds, tmp_path, writer):
    sides = {n: Side(n, w) for n, w in zip(("jax", "torch"), worlds)}
    reader = "torch" if writer == "jax" else "jax"
    x = _rng(9).standard_normal((8, 3, 5)).astype(np.float32)
    for layout in ("axis0", "flat"):
        d = tmp_path / layout
        sides[writer].sharded.save_sharded(
            str(d), sides[writer].array(x), name="arr", layout=layout)
        got = sides[reader].sharded.load_sharded(str(d), name="arr")
        assert same(got, x)


# ---------------------------------------------------------------------------
# the port's snapshots of mutable state
# ---------------------------------------------------------------------------

def test_async_save_is_a_snapshot(worlds, tmp_path):
    """save(async_=True), then an in-place update (what the port's train
    step does to parameters and AdamW state), then wait: the restore is
    the state as it was at the save."""
    world = worlds[1]
    ck = TCheckpointer(str(tmp_path), comm=world)
    p = torch.from_numpy(_rng(4).standard_normal((64, 64))
                         .astype(np.float32))
    opt = torch.optim.AdamW([p.requires_grad_()], lr=1e-2)
    p.grad = torch.ones_like(p)
    opt.step()
    state = {"p": p.detach(), "m": opt.state[p]["exp_avg"],
             "v": opt.state[p]["exp_avg_sq"]}
    want = {k: v.clone() for k, v in state.items()}
    ck.save(1, state, async_=True)
    for _ in range(3):
        opt.step()  # in place
    assert not torch.equal(state["p"], want["p"])
    ck.wait()
    got = ck.restore(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_async_save_sharded_is_a_snapshot(tmp_path):
    x = torch.arange(4 * 1000, dtype=torch.float32).reshape(4, 1000)
    want = x.clone()
    futs = tsharded.save_sharded(str(tmp_path), x, name="s", async_=True)
    x.mul_(-1)
    for f in futs:
        f.result()
    assert torch.equal(tsharded.load_sharded(str(tmp_path), name="s"), want)


# ---------------------------------------------------------------------------
# TestMemchecker: the donation counterpart
# ---------------------------------------------------------------------------

def test_donating_fn_marks_and_catches_reuse():
    step = tmem.donating_fn(lambda acc, g: acc + g, donate_argnums=(0,),
                            owner="grad_accumulate")
    acc = torch.ones(256, 256)
    g = torch.full((256, 256), 2.0)
    v0 = tpvar.PVARS.lookup("memchecker_violations").read()
    out = step(acc, g)
    assert float(out[0, 0]) == 3.0
    assert tmem._is_deleted(acc) and not tmem._is_deleted(g)
    assert tmem.owner_of(acc) == "grad_accumulate"
    with pytest.raises(TMPIError) as ei:
        tmem.check(acc)
    assert ei.value.code.name == "ERR_BUFFER"
    assert "grad_accumulate" in str(ei.value)
    with pytest.raises(TMPIError):
        step(acc, g)  # a consumed input is caught BEFORE the call
    assert tpvar.PVARS.lookup("memchecker_violations").read() - v0 == 2


def test_donating_fn_keeps_an_aliased_input():
    """An in-place update returns its input: the output aliases the
    donated tensor, which lives on as the output."""
    step = tmem.donating_fn(lambda acc, g: acc.add_(g), donate_argnums=(0,),
                            owner="inplace")
    acc = torch.ones(8)
    out = step(acc, torch.ones(8))
    assert out is acc and not tmem._is_deleted(acc)
    tmem.check(acc)


def test_assert_all_alive_names_the_leaf():
    good = {"w": torch.ones(4), "b": torch.zeros(2)}
    tmem.assert_all_alive(good)  # no raise
    step = tmem.donating_fn(lambda st, g: {"w": st["w"] + g},
                            donate_argnums=(0,), owner="tree_step")
    st = {"w": torch.ones(64, 64)}
    step(st, torch.ones(64, 64))
    with pytest.raises(TMPIError) as ei:
        tmem.assert_all_alive({"a": torch.ones(1), "dead": st["w"]},
                              what="params")
    assert "params leaf 1" in str(ei.value) and "tree_step" in str(ei.value)
    with pytest.raises(TMPIError) as ei:
        step(st, torch.ones(64, 64))  # consumed pytree caught first
    assert "tree_step" in str(ei.value)


def test_checkpoint_rejects_donated_state(tmp_path):
    """The memchecker walk before a save names the owner, as the JAX
    package's does (where its backend donates)."""
    step = tmem.donating_fn(lambda x: x * 2, donate_argnums=(0,),
                            owner="train_step")
    x = torch.ones(128, 128)
    step(x)
    ck = TCheckpointer(str(tmp_path / "ckpt"))
    with pytest.raises(TMPIError) as ei:
        ck.save(1, {"params": x}, async_=False)
    assert ei.value.code.name == "ERR_BUFFER"
    assert "train_step" in str(ei.value)
    assert ck.steps() == []
    # the JAX package: the same error class and owner where donation
    # happens on this backend
    jstep = jmem.donating_jit(lambda x: x * 2, donate_argnums=(0,),
                              owner="train_step")
    jx = jnp.ones((128, 128), jnp.float32)
    jstep(jx)
    if jx.is_deleted():
        with pytest.raises(JMPIError) as je:
            JCheckpointer(str(tmp_path / "jckpt")).save(
                1, {"params": jx}, async_=False)
        assert je.value.code.name == ei.value.code.name
        assert "train_step" in str(je.value)


def test_spanning_comm_refused(worlds, tmp_path):
    """On a communicator spanning processes the collective calls run the
    two-phase exchange (``io/two_phase.py``, held in
    ``tests/test_torch_spanning_jobs.py``) in the comm's collective
    posting order, blocking or posted; the shared file pointer and a
    Checkpointer without ``private_dir`` stay refused, as in the JAX
    package."""
    from ompi_release_tpu_torch.io import two_phase

    routed = []

    class Spanning:
        spans_processes = True
        name = "spanning"
        size = N

        def _run_serialized(self, fn, *args):
            routed.append(("run", fn))

        def _submit_serialized(self, fn, *args):
            routed.append(("submit", fn))

    f = tio.File(Spanning(), str(tmp_path / "x.bin"))
    f.write_at_all([0] * 4, [np.ones(1)] * 4)
    f.read_at_all([0] * 4, [1] * 4)
    f.iwrite_at_all([0] * 4, [np.ones(1)] * 4)
    f.iread_at_all([0] * 4, [1] * 4)
    assert routed == [("run", two_phase.write_at_all),
                      ("run", two_phase.read_at_all),
                      ("submit", two_phase.write_at_all),
                      ("submit", two_phase.read_at_all)]
    with pytest.raises(TMPIError) as ei:
        f.write_shared(np.ones(1))
    assert ei.value.code.name == "ERR_NOT_AVAILABLE"
    f.close()
    with pytest.raises(TMPIError):
        TCheckpointer(str(tmp_path / "c"), comm=Spanning())
