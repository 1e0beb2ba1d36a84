"""The port's one launch path (``cuda_op._launch``) and the partition of
the scale kernel, on the CPU.

The library and torch's stream lookup exist only on a machine with the
card, so these tests put stand-ins in their place (a fake library that
records its calls, a fake current device and raw stream) and show what
the helper hands the C entry, when it guards the device, that a failed
launch raises and is not counted, and that the library is loaded under
its lock once. Tensors on the ``meta`` device (not on the CPU, so the
wrappers take their kernel path; no data) show that every wrapper
launches through the helper. The kernels themselves run only in
``tests/test_torch_cuda_kernels.py``.

The one partition of the two streaming kernels (``cuda_op.stream_plan``:
one 16-byte vector of each operand per thread when every operand is
16-byte aligned, else one element per thread, and the tail after the
last whole vector on block 0) is emulated in plain index arithmetic at
the sizes around its vector, its block and a grid of many blocks
(``cuda_op.stream_boundary_sizes``), for ``stream_scale``'s two operands
and ``stream_axpy``'s three: every element is written exactly once, and
every vector access is 16-byte aligned.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from ompi_release_tpu_torch.ops import cuda_op
from ompi_release_tpu_torch.ops import flash_attention as fa
from ompi_release_tpu_torch.utils.errors import MPIError


class _FakeEntry:
    def __init__(self, calls, name, ret):
        self.calls, self.name, self.ret = calls, name, ret

    def __call__(self, *args):
        self.calls.append((self.name, args))
        return self.ret[0]


@pytest.fixture
def fake(monkeypatch):
    """A fake library whose every entry records its arguments and
    returns ``ret[0]``, on fake device ``current[0]`` whose current
    stream handle is ``stream[0]``."""
    calls, ret, current, stream = [], [0], [0], [0x5000]
    lib = types.SimpleNamespace(**{
        name: _FakeEntry(calls, name, ret)
        for name in ("stream_axpy", "stream_scale", "tile_transpose_32",
                     "chain_add_one", "flash_fwd")})
    monkeypatch.setattr(cuda_op, "_launcher", (
        lib, lambda: current[0], lambda device: stream[0] + device))
    guards = []

    @contextlib.contextmanager
    def guard(device):
        guards.append(device)
        yield

    monkeypatch.setattr(torch.cuda, "device", guard)
    cuda_op.reset_launches()
    yield types.SimpleNamespace(calls=calls, ret=ret, current=current,
                                stream=stream, guards=guards)
    cuda_op.reset_launches()


def test_launch_hands_its_arguments_and_the_stream_to_the_entry(fake):
    cuda_op._launch("stream_axpy", "axpy", 0, 1, 0x100, 0x200, 0x300, 0.5,
                    0, 4097)
    assert fake.calls == [("stream_axpy",
                           (1, 0x100, 0x200, 0x300, 0.5, 0, 4097, 0x5000))]
    assert cuda_op.LAUNCHES["axpy"] == 1
    assert fake.guards == []  # the tensor's device is the current one


def test_launch_reads_the_stream_at_every_call(fake):
    cuda_op._launch("chain_add_one", "chain", 0, 0x10, 0x20)
    fake.stream[0] = 0x7000  # another current stream (a side stream)
    cuda_op._launch("chain_add_one", "chain", 0, 0x10, 0x20)
    handles = [args[-1] for _, args in fake.calls]
    assert handles == [0x5000, 0x7000]
    assert cuda_op.LAUNCHES["chain"] == 2


def test_launch_guards_only_another_device(fake):
    fake.current[0] = 0
    cuda_op._launch("stream_scale", "scale", 1, 0, 0x10, 0x20, 2.0, 8)
    assert fake.guards == [1]
    assert fake.calls[-1][1][-1] == 0x5000 + 1  # device 1's stream
    cuda_op._launch("stream_scale", "scale", 0, 0, 0x10, 0x20, 2.0, 8)
    assert fake.guards == [1]
    assert cuda_op.LAUNCHES["scale"] == 2


def test_failed_launch_raises_naming_the_kernel_and_is_not_counted(fake):
    fake.ret[0] = 700
    with pytest.raises(MPIError, match="tile_transpose_32 launch failed: "
                                       "CUDA error 700"):
        cuda_op._launch("tile_transpose_32", "transpose", 0, 0x10, 0x20, 3,
                        4)
    assert cuda_op.LAUNCHES["transpose"] == 0
    assert len(fake.calls) == 1  # launched once, never retried


def test_launch_refuses_a_tensor_off_the_card(fake):
    with pytest.raises(MPIError, match="takes CUDA tensors"):
        cuda_op._launch("stream_scale", "scale", -1, 0, 0x10, 0x20, 2.0, 8)
    assert fake.calls == [] and cuda_op.LAUNCHES["scale"] == 0


def test_load_takes_the_lock_only_on_the_first_load(monkeypatch):
    entered = []

    class CountingLock:
        def __enter__(self):
            entered.append(1)

        def __exit__(self, *exc):
            return False

    class FakeDLL:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, name):  # an entry whose types may be set
            entry = types.SimpleNamespace()
            setattr(self, name, entry)
            return entry

    monkeypatch.setattr(cuda_op, "_lib", None)
    monkeypatch.setattr(cuda_op, "_lib_lock", CountingLock())
    monkeypatch.setattr(cuda_op, "build", lambda: "/nonexistent/lib.so")
    monkeypatch.setattr(cuda_op.ctypes, "PyDLL", FakeDLL)
    first = cuda_op._load()
    assert entered == [1] and first.path == "/nonexistent/lib.so"
    assert cuda_op._load() is first and cuda_op._load() is first
    assert entered == [1]


def test_every_wrapper_launches_through_the_helper(monkeypatch):
    launched = []
    monkeypatch.setattr(cuda_op, "_launch",
                        lambda kernel, counter, device, *args:
                        launched.append((kernel, counter)))
    meta = lambda *shape: torch.empty(*shape, device="meta")  # noqa: E731
    x = meta(100)
    cuda_op.sum_(x, x)
    cuda_op.axpy(x, x, 2.0)
    cuda_op.scale(x, 2.0)
    cuda_op.transpose(meta(10, 10))
    cuda_op.chain_hop(meta(*cuda_op.CHAIN_TILE))
    q = meta(2, 70, 8)
    out, lse = fa.flash_forward(q, q, q, True)
    fa.flash_backward(q, q, q, out, lse, q, True)
    assert launched == [
        ("stream_axpy", "sum"), ("stream_axpy", "axpy"),
        ("stream_scale", "scale"), ("tile_transpose_32", "transpose"),
        ("chain_add_one", "chain"), ("flash_fwd", "flash_fwd"),
        ("flash_bwd_dq", "flash_bwd_dq"), ("flash_bwd_dkv", "flash_bwd_dkv")]


# ---------------------------------------------------------------------------
# the streaming kernels' partition
# ---------------------------------------------------------------------------

def _emulate(n, itemsize, addrs):
    """How many times the kernel writes each element, walking its
    threads as the C code does: thread i's vector (or element), then
    block 0's first threads over the tail after the last whole vector."""
    unit, units, grid = cuda_op.stream_plan(n, itemsize, *addrs)
    assert grid >= 1 and grid * cuda_op.STREAM_THREADS >= units
    writes = np.zeros(n + 1, np.int64)  # one spare slot catches overruns
    i = np.arange(grid * cuda_op.STREAM_THREADS)
    mine = i[i < units]
    if unit > 1:  # every vector access 16-byte aligned on every operand
        for addr in addrs:
            assert ((addr + mine * 16) % 16 == 0).all()
    writes[:units * unit] += np.bincount(
        (mine[:, None] * unit + np.arange(unit)[None, :]).ravel(),
        minlength=units * unit)[:units * unit]
    tail = n - units * unit
    assert tail < cuda_op.STREAM_THREADS
    writes[units * unit + np.arange(tail)] += 1
    return writes[:n], writes[n], (unit, units, grid)


def _sizes(itemsize):
    return sorted({0, 1, 15, 16, 17,
                   *cuda_op.stream_boundary_sizes(itemsize)})


_PARTITION_CASES = [(itemsize, n) for itemsize in (4, 2)
                    for n in _sizes(itemsize)]


def _writes_every_element_once(n, itemsize, placements):
    """The partition over operands at each placement's offsets (bytes
    past 16-byte aligned bases): vectors exactly when every operand is
    aligned, and every element written once (emulated once per distinct
    plan: a misaligned placement's plan does not depend on which operand
    is off the grid)."""
    done = set()
    for offsets in placements:
        addrs = [0x7F0000000000 + k * 0x1000000000 + off
                 for k, off in enumerate(offsets)]
        plan = cuda_op.stream_plan(n, itemsize, *addrs)
        assert plan[0] == (1 if any(offsets) else 16 // itemsize), offsets
        if plan not in done:
            done.add(plan)
            writes, spill, _ = _emulate(n, itemsize, addrs)
            assert (writes == 1).all() and spill == 0, (n, offsets)


@pytest.mark.parametrize("itemsize,n", _PARTITION_CASES)
def test_scale_partition_writes_every_element_once(itemsize, n):
    # x at every head offset mod 16, out at the same offset and aligned
    _writes_every_element_once(n, itemsize, [
        (x_off, out_off) for x_off in range(0, 16, itemsize)
        for out_off in {x_off, 0}])


@pytest.mark.parametrize("itemsize,n", _PARTITION_CASES)
def test_axpy_partition_writes_every_element_once(itemsize, n):
    """``stream_axpy``'s three operands (a, acc, out): all aligned, then
    each one alone off the 16-byte grid at every offset mod 16."""
    _writes_every_element_once(n, itemsize, [(0, 0, 0)] + [
        tuple(off if k == which else 0 for k in range(3))
        for which in range(3) for off in range(itemsize, 16, itemsize)])


@pytest.mark.parametrize("itemsize", [4, 2])
def test_scale_plan_at_the_main_path_size(itemsize):
    n = 1 << 26  # the bench loops' and the SUM's 2^26 elements
    unit, units, grid = cuda_op.stream_plan(n, itemsize, 0x10000, 0x20000)
    assert (unit, units) == (16 // itemsize, n * itemsize // 16)
    assert grid == units // cuda_op.STREAM_THREADS  # one vector a thread


@pytest.mark.parametrize("itemsize", [4, 2])
def test_axpy_plan_at_the_main_path_size(itemsize):
    """The SUM of 2^26 elements takes the same grid as the scale kernel,
    one vector of each operand a thread: 65,536 blocks in f32, uncapped."""
    n = 1 << 26
    plan = cuda_op.stream_plan(n, itemsize, 0x10000, 0x20000, 0x30000)
    assert plan == cuda_op.stream_plan(n, itemsize, 0x10000, 0x20000)
    unit, units, grid = plan
    assert (unit, units) == (16 // itemsize, n * itemsize // 16)
    assert grid == units // cuda_op.STREAM_THREADS
    assert grid == (65536 if itemsize == 4 else 32768)


@pytest.mark.parametrize("itemsize", [4, 2])
def test_scale_boundary_sizes_sit_on_the_partition_edges(itemsize):
    """Each boundary size lands where its name says: around one vector
    (no whole vector, one, one and a tail), one block of vectors and a
    grid of 4,097 blocks (one thread short of full, full, full and a
    tail, full and the longest tail)."""
    vec = 16 // itemsize
    sizes = cuda_op.stream_boundary_sizes(itemsize)
    plans = [cuda_op.stream_plan(n, itemsize, 0x10000, 0x20000)
             for n in sizes]
    units = [p[1] for p in plans]
    grids = [p[2] for p in plans]
    block = cuda_op.STREAM_THREADS
    assert units[:3] == [0, 1, 1] and grids[:3] == [1, 1, 1]
    assert units[3:6] == [block - 1, block, block] and grids[3:6] == [1, 1, 1]
    assert units[6:] == [4097 * block - 1, 4097 * block, 4097 * block,
                         4097 * block]
    assert grids[6:] == [4097] * 4
    tails = [n - u * vec for n, u in zip(sizes, units)]
    assert tails == [vec - 1, 0, 1, vec - 1, 0, 1, vec - 1, 0, 1, vec - 1]
