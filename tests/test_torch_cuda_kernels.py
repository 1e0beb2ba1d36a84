"""The port's CUDA kernels on the card, held against their plain
PyTorch twins. Every test needs a CUDA device and skips without
one (the decision is taken inside the fixture, never at import).

Run on a machine with the card:
``python -m pytest tests/test_torch_cuda_kernels.py -q``.

Tolerances: ``sum``, ``axpy`` and ``scale`` bitwise (one IEEE add, a
multiply then an add, or one multiply per element, in f32 with explicit
round-to-nearest intrinsics and no FMA, bf16 widened and rounded once,
on both sides), also at the sizes around their partition's vector, its
block and a grid of many blocks; ``transpose`` and ``chain_hop`` bitwise
(a move of 32-bit words; one IEEE add); ``ring_fold`` bitwise its twin
and the interpreted ring (the same adds in the same order, bf16 rounded
after every step on every side). ``flash_fwd``: ``out`` f32
rtol/atol 2e-5 (the JAX suite's
own, ``tests/test_pallas.py``), bf16 within 1 bf16 ulp plus that atol,
``lse`` atol 1e-5; kernel and twin both compute in f32, in another
summation order, and each rounds its own f32 result to bf16 once: near
zero the two f32 sums differ by more than a bf16 ulp of the value (the
bf16 kernel feeds P to the tensor cores as a bf16 hi + lo pair, which
keeps it within that rule: ``tests/test_torch_flash_split.py``).
``flash_bwd_dq`` / ``flash_bwd_dkv``: dq, dk, dv f32 rtol/atol 2e-4 (the
JAX suite's grad tolerance, ``tests/test_pallas.py:101``), bf16 within
1 bf16 ulp plus that atol, for the same reason as the forward: each
gradient is an f32 sum of up to S products taken in another order on
each side, and each side rounds its own sum once (the bf16 kernels feed
P and dS to the tensor cores as bf16 hi + lo pairs, which keeps them
within that rule: ``tests/test_torch_flash_split.py``). The backward is
bitwise deterministic (each output is owned by one block; no atomics).
"""

import pytest
import torch

from ompi_release_tpu_torch.ops import cuda_op
from ompi_release_tpu_torch.ops import flash_attention as fa
from ompi_release_tpu_torch.utils.errors import MPIError

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _ulp_ok(got, want, dtype, atol=0.0):
    got, want = got.float(), want.float()
    if dtype is torch.float32:
        return torch.allclose(got, want, rtol=1e-6, atol=0)
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    return bool(((got - want).abs() <= ulp + atol).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,offset", [(1, 0), (4097, 0), ((1 << 20) + 3, 0),
                                      (4097, 1)])
def test_kernels_match_plain_twins(dev, dtype, n, offset):
    g = torch.Generator(device=dev).manual_seed(n + offset)
    base = torch.randn(2, n + offset, generator=g, device=dev).to(dtype)
    a, b = base[0, offset:], base[1, offset:]  # offset 1: misaligned view
    assert a.is_contiguous()
    view = torch.int32 if dtype is torch.float32 else torch.int16
    for got, want in (
            (cuda_op.sum_(a, b), cuda_op._plain_sum(a, b)),
            (cuda_op.axpy(a, b, 0.999), cuda_op._plain_axpy(a, b, 0.999)),
            (cuda_op.scale(a, 1.0001), cuda_op._plain_scale(a, 1.0001))):
        assert torch.equal(got.view(view), want.view(view))
    torch.cuda.synchronize()


def test_launches_counted_per_wrapper(dev):
    cuda_op.reset_launches()
    x = torch.ones(1000, device=dev)
    cuda_op.sum_(x, x)
    cuda_op.axpy(x, x, 2.0)
    cuda_op.axpy(x, x, 2.0)
    cuda_op.scale(x, 3.0)
    cuda_op.transpose(x.view(10, 100))
    cuda_op.chain_hop(torch.ones(cuda_op.CHAIN_TILE, device=dev))
    q = torch.ones(2, 70, 8, device=dev)
    fa.flash_forward(q, q, q, True)
    fa.flash_attention(q, q, q)
    fa._plain_flash_forward(q, q, q, True)  # the twin launches nothing
    qg = q.clone().requires_grad_()
    fa.flash_attention(qg, q, q, True).sum().backward()  # one backward
    out, lse = fa._plain_flash_forward(q, q, q, True)
    fa._plain_flash_backward(q, q, q, out, lse, q, True)
    assert cuda_op.LAUNCHES == {"sum": 1, "axpy": 2, "scale": 1,
                                "transpose": 1, "chain": 1, "flash_fwd": 3,
                                "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
                                "ring_fold": 0}


def test_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    x = torch.ones(64, 64, device=dev)
    with pytest.raises(MPIError, match="contiguous"):
        cuda_op.sum_(x.t(), x)
    with pytest.raises(MPIError, match="float32/bfloat16"):
        cuda_op.scale(torch.ones(8, dtype=torch.int32, device=dev), 2.0)
    with pytest.raises(MPIError, match="differ"):
        cuda_op.sum_(x, torch.ones(64, device=dev))
    with pytest.raises(MPIError, match="contiguous"):
        cuda_op.transpose(x.t())
    with pytest.raises(MPIError, match="int32/float32"):
        cuda_op.transpose(x.to(torch.bfloat16))
    with pytest.raises(MPIError, match="float32 tile"):
        cuda_op.chain_hop(torch.ones(8, 256, device=dev))
    tile = torch.ones(2 * 8 * 128 + 1, device=dev)[1:1 + 8 * 128]
    with pytest.raises(MPIError, match="aligned"):
        cuda_op.chain_hop(tile.view(cuda_op.CHAIN_TILE))


@pytest.mark.parametrize("shape,dtype", [
    ((8192, 8192), torch.int32), ((4097, 1000), torch.float32),
    ((1, 1), torch.float32), ((33, 65), torch.int32),
    ((65535 * 32 + 40, 3), torch.int32),  # more tile rows than gridDim.y
])
def test_transpose_bitwise(dev, shape, dtype):
    g = torch.Generator(device=dev).manual_seed(shape[0])
    x = torch.randint(-2**31, 2**31 - 1, shape, generator=g, device=dev,
                      dtype=torch.int32).view(dtype)  # every bit pattern
    got = cuda_op.transpose(x)
    want = cuda_op._plain_transpose(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    torch.cuda.synchronize()


def test_chain_hop_and_loops(dev):
    x = torch.randn(cuda_op.CHAIN_TILE, device=dev)
    assert torch.equal(cuda_op.chain_hop(x), x + 1)
    a = torch.zeros(cuda_op.CHAIN_TILE, device=dev)
    k = cuda_op.GRAPH_BLOCK + 5  # one replay plus an eager remainder
    for graph in (False, True):
        loop = cuda_op.make_chain_loop(4, graph=graph)
        assert float(loop(a, k)) == 2 * 4 * k
        assert float(loop(a, 1)) == 8  # a replayed graph reads a afresh
    t_loop, _ = cuda_op.make_transpose_loop(256)
    b = torch.arange(256 * 256, device=dev, dtype=torch.int32).view(256, 256)
    assert int(t_loop(b, 3)) == 256 * 256 - 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", range(10))
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("wrapper", ["scale", "sum", "axpy"])
def test_scale_bitwise_at_design_boundaries(dev, dtype, which, offset,
                                            wrapper):
    """Each streaming kernel against its twin, bitwise (the same f32
    operations rounded once on both sides), at the sizes around their
    partition's vector, its block and a grid of many blocks
    (``cuda_op.stream_boundary_sizes``). Offset 1 puts every operand off
    the 16-byte grid (one element per thread)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    n = cuda_op.stream_boundary_sizes(itemsize)[which]
    g = torch.Generator(device=dev).manual_seed(n + offset)
    base = torch.randn(2, n + offset, generator=g, device=dev).to(dtype)
    a, b = base[0, offset:], base[1, offset:]
    got, want = {
        "scale": lambda: (cuda_op.scale(a, 1.0001),
                          cuda_op._plain_scale(a, 1.0001)),
        "sum": lambda: (cuda_op.sum_(a, b), cuda_op._plain_sum(a, b)),
        "axpy": lambda: (cuda_op.axpy(a, b, 0.999),
                         cuda_op._plain_axpy(a, b, 0.999)),
    }[wrapper]()
    torch.cuda.synchronize()
    view = torch.int32 if dtype is torch.float32 else torch.int16
    assert torch.equal(got.view(view), want.view(view))


def _captured(fn):
    """``fn()`` run eagerly inside ``torch.cuda.stream(side)``, then
    captured into a CUDA graph (which captures on a side stream of its
    own) and replayed: (eager result, replayed result)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = fn()
    graph.replay()
    torch.cuda.synchronize()
    return eager, replayed


@pytest.mark.parametrize("wrapper", ["sum", "axpy", "scale", "chain",
                                     "transpose", "flash_fwd"])
def test_wrappers_launch_on_the_current_side_stream(dev, wrapper):
    """Each wrapper launches on the stream current at the call: on a
    side stream, and into a graph under capture (a launch on any other
    stream would break the capture); the replay gives the same bits."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(1 << 20, generator=g, device=dev)
    q = torch.randn(2, 100, 64, generator=g, device=dev).to(torch.bfloat16)
    y = torch.randn(1 << 20, generator=g, device=dev)
    fn = {"sum": lambda: cuda_op.sum_(x, y),
          "axpy": lambda: cuda_op.axpy(x, y, 0.999),
          "scale": lambda: cuda_op.scale(x, 1.0001),
          "chain": lambda: cuda_op.chain_hop(x[:1024].view(
              cuda_op.CHAIN_TILE)),
          "transpose": lambda: cuda_op.transpose(x.view(1024, 1024)),
          "flash_fwd": lambda: fa.flash_forward(q, q, q, True)[0]}[wrapper]
    cuda_op.reset_launches()
    eager, replayed = _captured(fn)
    assert sum(cuda_op.LAUNCHES.values()) == 2  # eager + capture
    view = torch.int16 if eager.dtype is torch.bfloat16 else torch.int32
    assert torch.equal(eager.view(view), replayed.view(view))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [1, 100, 129, 2048])
@pytest.mark.parametrize("d", [8, 64, 128])
def test_flash_fwd_matches_plain_twin(dev, dtype, causal, s, d):
    g = torch.Generator(device=dev).manual_seed(s * 1000 + d)
    q, k, v = (torch.randn(3, s, d, generator=g, device=dev).to(dtype)
               for _ in range(3))
    out, lse = fa.flash_forward(q, k, v, causal)
    want, want_lse = fa._plain_flash_forward(q, k, v, causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and lse.dtype == torch.float32
    if dtype is torch.float32:
        assert torch.allclose(out, want, rtol=2e-5, atol=2e-5)
    else:
        assert _ulp_ok(out, want, dtype, atol=2e-5)
    assert torch.allclose(lse, want_lse, rtol=0, atol=1e-5)


def test_flash_fwd_full_width_and_batched_layout(dev):
    """The model's shape, (B, H, S, D) = (8, 8, 2048, 64) bf16 causal:
    the leading dims flatten into 64 heads of one launch."""
    g = torch.Generator(device=dev).manual_seed(64)
    q, k, v = (torch.randn(8, 8, 2048, 64, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    out, lse = fa.flash_forward(q, k, v, True)
    want, want_lse = fa._plain_flash_forward(
        *(t.view(64, 2048, 64) for t in (q, k, v)), True)
    torch.cuda.synchronize()
    assert out.shape == q.shape and lse.shape == (8, 8, 2048)
    assert _ulp_ok(out.view(64, 2048, 64), want, torch.bfloat16, atol=2e-5)
    assert torch.allclose(lse.view(64, 2048), want_lse, rtol=0, atol=1e-5)


def test_flash_fwd_full_width_d128(dev):
    """The model's width in 128-wide heads, (B, H, S, D) = (8, 4, 2048,
    128) bf16 causal: the tensor-core forward at its wider instance,
    against the plain twin."""
    g = torch.Generator(device=dev).manual_seed(128)
    q, k, v = (torch.randn(8, 4, 2048, 128, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    out, lse = fa.flash_forward(q, k, v, True)
    want, want_lse = fa._plain_flash_forward(
        *(t.view(32, 2048, 128) for t in (q, k, v)), True)
    torch.cuda.synchronize()
    assert out.shape == q.shape and lse.shape == (8, 4, 2048)
    assert _ulp_ok(out.view(32, 2048, 128), want, torch.bfloat16, atol=2e-5)
    assert torch.allclose(lse.view(32, 2048), want_lse, rtol=0, atol=1e-5)


@pytest.mark.parametrize("d,offset", [(20, 0), (72, 0), (64, 1)])
def test_flash_fwd_bf16_element_loads(dev, d, offset):
    """The bf16 forward copies 16-byte rows only when D % 8 == 0 and q,
    k, v are 16-byte aligned; a head dim of 20 and views at element
    offset 1 take its element loads instead, 72 the wider instance."""
    g = torch.Generator(device=dev).manual_seed(d + offset)
    n = 2 * 100 * d
    q, k, v = (torch.randn(n + offset, generator=g, device=dev)
               .to(torch.bfloat16)[offset:].view(2, 100, d)
               for _ in range(3))
    out, lse = fa.flash_forward(q, k, v, True)
    want, want_lse = fa._plain_flash_forward(q, k, v, True)
    torch.cuda.synchronize()
    assert _ulp_ok(out, want, torch.bfloat16, atol=2e-5)
    assert torch.allclose(lse, want_lse, rtol=0, atol=1e-5)


def test_flash_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    q = torch.randn(2, 64, 64, device=dev)
    with pytest.raises(MPIError, match="contiguous"):
        fa.flash_forward(q.transpose(1, 2).contiguous().transpose(1, 2),
                         q, q, True)
    big = torch.randn(2, 64, 129, device=dev)
    with pytest.raises(MPIError, match="head dim 129"):
        fa.flash_forward(big, big, big, True)
    h = q.half()
    with pytest.raises(MPIError, match="float32/bfloat16"):
        fa.flash_forward(h, h, h, True)
    with pytest.raises(MPIError, match="differ"):
        fa.flash_forward(q, q.cpu(), q, True)
    with pytest.raises(MPIError, match="65535"):
        w = torch.empty(65536, 1, 1, device=dev)
        fa.flash_forward(w, w, w, True)
    # under grad the backward runs the kernels and matches the twin
    qg = q.clone().requires_grad_()
    out = fa.flash_attention(qg, q, q)
    (dq,) = torch.autograd.grad(out, qg, torch.ones_like(out))
    o, lse = fa._plain_flash_forward(q, q, q, False)
    want = fa._plain_flash_backward(q, q, q, o, lse, torch.ones_like(q),
                                    False)[0]
    assert torch.allclose(dq, want, rtol=2e-4, atol=2e-4)
    with pytest.raises(MPIError, match="contiguous"):
        fa.flash_backward(q, q, q, o, lse, q.transpose(1, 2).contiguous()
                          .transpose(1, 2), True)
    with pytest.raises(MPIError, match="lse"):
        fa.flash_backward(q, q, q, o, lse.to(torch.bfloat16), q, True)


def _bwd_inputs(dev, dtype, shape, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(*shape, generator=g, device=dev).to(dtype)
                   for _ in range(4))
    return q, k, v, do


def _grads_close(got, want, dtype):
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        if dtype is torch.float32:
            assert torch.allclose(a, b, rtol=2e-4, atol=2e-4)
        else:
            assert _ulp_ok(a, b, dtype, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [1, 100, 129, 256])
@pytest.mark.parametrize("d", [8, 64, 128])
def test_flash_bwd_matches_plain_twin(dev, dtype, causal, s, d):
    q, k, v, do = _bwd_inputs(dev, dtype, (3, s, d), s * 1000 + d)
    out, lse = fa.flash_forward(q, k, v, causal)
    got = fa.flash_backward(q, k, v, out, lse, do, causal)
    want = fa._plain_flash_backward(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    _grads_close(got, want, dtype)


def test_flash_bwd_full_width_deterministic_and_batched(dev):
    """The model's shape, (B, H, S, D) = (8, 8, 2048, 64) bf16 causal,
    through autograd with the model's transposed cotangent; two runs of
    the backward are bitwise equal."""
    q, k, v, do = _bwd_inputs(dev, torch.bfloat16, (8, 8, 2048, 64), 64)
    out, lse = fa.flash_forward(q, k, v, True)
    want = fa._plain_flash_backward(
        *(t.view(64, 2048, 64) for t in (q, k, v, out)), lse.view(64, 2048),
        do.view(64, 2048, 64), True)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    g_t = do.transpose(1, 2).contiguous().transpose(1, 2)  # not contiguous
    first = torch.autograd.grad(fa.flash_attention(*leaves, True), leaves,
                                g_t)
    again = fa.flash_backward(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    _grads_close([t.view(64, 2048, 64) for t in first], want, torch.bfloat16)
    for a, b in zip(first, again):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_flash_bwd_full_width_d128(dev):
    """The model's width in 128-wide heads, (B, H, S, D) = (8, 4, 2048,
    128) bf16 causal: the tensor-core kernels at their wider instance,
    against the plain twin; two runs bitwise equal."""
    q, k, v, do = _bwd_inputs(dev, torch.bfloat16, (8, 4, 2048, 128), 128)
    out, lse = fa.flash_forward(q, k, v, True)
    got = fa.flash_backward(q, k, v, out, lse, do, True)
    again = fa.flash_backward(q, k, v, out, lse, do, True)
    want = fa._plain_flash_backward(
        *(t.view(32, 2048, 128) for t in (q, k, v, out)), lse.view(32, 2048),
        do.view(32, 2048, 128), True)
    torch.cuda.synchronize()
    _grads_close([t.view(32, 2048, 128) for t in got], want, torch.bfloat16)
    for a, b in zip(got, again):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("d,offset", [(20, 0), (72, 0), (64, 1)])
def test_flash_bwd_bf16_element_loads(dev, d, offset):
    """The bf16 kernels copy 16-byte rows only when D % 8 == 0 and every
    operand is 16-byte aligned; a head dim of 20 and views at element
    offset 1 take their element loads instead, 72 the wider instance."""
    g = torch.Generator(device=dev).manual_seed(d + offset)
    n = 2 * 100 * d
    q, k, v, do = (torch.randn(n + offset, generator=g, device=dev)
                   .to(torch.bfloat16)[offset:].view(2, 100, d)
                   for _ in range(4))
    out, lse = fa.flash_forward(q, k, v, True)
    got = fa.flash_backward(q, k, v, out, lse, do, True)
    want = fa._plain_flash_backward(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    _grads_close(got, want, torch.bfloat16)


# ---------------------------------------------------------------------------
# coll/plan.py's frozen plans: CUDA graphs of the cached bodies
# ---------------------------------------------------------------------------

@pytest.fixture
def tuned(dev):
    """A tuned communicator of 8 virtual ranks on the card."""
    import ompi_release_tpu_torch as mpi
    from ompi_release_tpu_torch.mca import var
    from ompi_release_tpu_torch.runtime import runtime as rt

    rt._reset_for_tests()
    world = mpi.init(cli_args=["--mca", "runtime_virtual_ranks", "8"])
    var.set_value("coll", "tuned")
    try:
        comm = world.dup(name="plan_tuned")
    finally:
        var.VARS.unset("coll")
    yield comm
    comm.free()
    rt._reset_for_tests()
    var.VARS.unset("runtime_virtual_ranks")


def _plans(comm):
    from ompi_release_tpu_torch.coll import plan

    return [e for k, e in plan._device_plans.items() if k[0] == comm.cid]


@pytest.mark.parametrize("nbytes", [8, 64 << 10, 4 << 20, 16 << 20])
def test_plan_replays_bitwise_and_counts_launches(tuned, nbytes):
    """The second call captures the tuned allreduce's body as a graph;
    every replay is bitwise the interpreted leg, and each replay counts
    the launches its graph captured: from 64 KiB a rank the ring's one
    ``ring_fold`` (plain, pipelined at 4 MiB, segmented at 16 MiB), no
    SUM launch of its own; at 8 B recursive doubling's plain adds."""
    from ompi_release_tpu_torch import ops

    x = torch.randn(8, nbytes // 4, device=tuned.device)
    want = tuned.c_coll["allreduce"](tuned, x, ops.SUM)
    outs = [tuned.allreduce(x) for _ in range(3)]
    (entry,) = _plans(tuned)
    assert entry["frozen"].graph is not None
    captured = entry["frozen"].launches
    assert captured.get("sum", 0) == 0
    assert captured.get("ring_fold", 0) == (1 if nbytes >= 64 << 10 else 0)
    before = dict(cuda_op.LAUNCHES)
    outs.append(tuned.allreduce(x))
    for k in ("sum", "ring_fold"):
        assert cuda_op.LAUNCHES[k] - before[k] == captured.get(k, 0)
    for o in outs:
        assert torch.equal(o.view(torch.int32), want.view(torch.int32))


def test_plan_capture_failure_stays_interpreted(tuned):
    """A body that syncs with the host cannot be captured: the plan
    turns "bad" with the reason, later calls run interpreted with the
    same bits, and the next capture (a fresh pool) succeeds."""
    from ompi_release_tpu_torch import ops

    op = ops.user_op("sum_host_sync",
                     lambda a, b: (float(b.reshape(-1)[0]), a + b)[1])
    x = torch.randn(8, 1024, device=tuned.device)
    want = tuned.c_coll["allreduce"](tuned, x, op)
    for _ in range(3):
        assert torch.equal(tuned.allreduce(x, op).view(torch.int32),
                           want.view(torch.int32))
    (entry,) = _plans(tuned)
    assert "capture failed" in entry["bad"]
    y = torch.randn(8, 1 << 20, device=tuned.device)
    for _ in range(2):
        tuned.allreduce(y)
    assert sum(e.get("frozen") is not None and e["frozen"].graph is not None
               for e in _plans(tuned)) == 1


def test_persistent_plan_dies_with_its_request(tuned):
    """A persistent request whose buffer lies on the card replays a graph
    that reads the buffer in place (no input copy), bitwise the
    interpreted leg; dropping the request frees the graph's memory."""
    import gc

    from ompi_release_tpu_torch import ops

    gc.collect()
    base = torch.cuda.memory_allocated(tuned.device)
    buf = torch.randn(8, 4 << 20, device=tuned.device)
    req = tuned.allreduce_init(buf)
    for _ in range(3):
        buf.normal_()
        want = tuned.c_coll["allreduce"](tuned, buf, ops.SUM)
        req.start()
        req.wait()
        assert torch.equal(req.value.view(torch.int32),
                           want.view(torch.int32))
    assert not _plans(tuned)  # the plan is the request's, not the comm's
    held = torch.cuda.memory_allocated(tuned.device) - base
    del req, buf, want
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(tuned.device) - base < held
    assert torch.cuda.memory_allocated(tuned.device) - base <= 1 << 20


# ---------------------------------------------------------------------------
# osc/plan.py's frozen epoch plans: CUDA graphs of the unrolled closes
# ---------------------------------------------------------------------------

def _epochs(win, ops, pays, sync="lock"):
    """Run one epoch per payload pair (put, accumulate, get, indexed
    fetch-and-op, indexed CAS on target 2); returns every read and the
    window after each."""
    out = []
    for a, b in pays:
        if sync == "lock":
            win.lock(2)
        else:
            win.fence()
        win.put(a, target=2)
        win.accumulate(b, target=2, op=ops.SUM)
        g = win.get(target=2)
        f = win.fetch_and_op(b[5], target=2, op=ops.MAX, index=5)
        c = win.compare_and_swap(a[1], b[1], target=2, index=1)
        if sync == "lock":
            win.unlock(2)
        else:
            win.fence_end()
        out += [g.value, f.value, c.value, win.read()]
    return out


@pytest.mark.parametrize("sync", ["lock", "fence"])
def test_epoch_plan_replays_as_graph_bitwise(tuned, sync):
    """The first close of a signature runs interpreted, the second
    captures the unrolled close as a CUDA graph, later closes replay it:
    every read and the window bitwise the interpreted closes
    (``osc_compiled`` off)."""
    from ompi_release_tpu_torch import ops
    from ompi_release_tpu_torch.mca import var
    from ompi_release_tpu_torch.osc import win_allocate

    g = torch.Generator(device=tuned.device).manual_seed(5)
    pays = [(torch.randn(1 << 16, generator=g, device=tuned.device),
             torch.randn(1 << 16, generator=g, device=tuned.device))
            for _ in range(5)]
    var.set_value("osc_compiled", False)
    try:
        wi = win_allocate(tuned, (1 << 16,))
        want = _epochs(wi, ops, pays, sync)
    finally:
        var.VARS.unset("osc_compiled")
    wc = win_allocate(tuned, (1 << 16,))
    got = _epochs(wc, ops, pays, sync)
    (plan,) = wc._access_plans.values()
    assert plan.graph is not None and plan.bad is None
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    wi.free()
    wc.free()


def test_epoch_plan_capture_failure_stays_interpreted(tuned):
    """A user op that syncs with the host cannot be captured: the plan
    keeps its reason and stays interpreted with the interpreted bits;
    its pool is never captured into again, and the next signature's
    capture (a fresh pool) succeeds."""
    from ompi_release_tpu_torch import ops
    from ompi_release_tpu_torch.mca import pvar
    from ompi_release_tpu_torch.osc import win_allocate

    op = ops.user_op("sum_host_sync",
                     lambda a, b: (float(b.reshape(-1)[0]), a + b)[1])
    failures = pvar.PVARS.lookup("osc_graph_capture_failures")
    f0 = failures.read()
    x = torch.randn(4096, device=tuned.device)
    w = win_allocate(tuned, (4096,))
    want = torch.zeros_like(x)
    for _ in range(3):
        w.fence()
        w.accumulate(x, target=1, op=op)
        w.fence_end()
        want = want + x
        assert torch.equal(w.read()[1], want)
    (plan,) = w._access_plans.values()
    assert "capture failed" in plan.bad and plan.graph is None
    assert failures.read() - f0 == 1
    for _ in range(2):
        w.fence()
        w.accumulate(x, target=3)
        w.fence_end()
    graphs = [p for p in w._access_plans.values() if p.graph is not None]
    assert len(graphs) == 1
    assert torch.equal(w.read()[3], x + x)
    w.free()


# ---------------------------------------------------------------------------
# slice 9: the axis psum's autograd Function on the SUM kernel, and the
# sharded TpuLM's flash launches
# ---------------------------------------------------------------------------

def _op_excluded(fn):
    """``fn()`` with ``--mca op ^cuda``: the plain add in the same fold."""
    from ompi_release_tpu_torch.mca import var as tvar

    tvar.set_value("op", "^cuda")
    try:
        return fn()
    finally:
        tvar.VARS.unset("op")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ranks", [2, 4])
def test_axis_psum_on_the_sum_kernel_bitwise(dev, dtype, ranks):
    """``axes.psum`` over tp (a fold of 16 MiB operands: the SUM kernel
    claims them) and ``axes.vary``'s backward (the cotangents' fold)
    against the same calls with ``--mca op ^cuda``, forward and backward,
    bitwise; the kernel launches in both directions."""
    from ompi_release_tpu_torch.parallel import axes
    from ompi_release_tpu_torch.parallel.mesh_axes import ParallelMesh

    mesh = ParallelMesh(shape={"dp": 2, "tp": ranks}, device=dev)
    g = torch.Generator(device=dev).manual_seed(ranks)
    x = torch.randn(2, ranks, 8 * 1024 * 1024 // ranks, generator=g,
                    device=dev).to(dtype)
    h = torch.randn(2, 1, x.shape[-1], generator=g, device=dev).to(dtype)
    cot = torch.randn(2, 1, x.shape[-1], generator=g, device=dev).to(dtype)

    def run():
        xi = x.clone().requires_grad_(True)
        hi = h.clone().requires_grad_(True)
        with mesh:
            y = axes.psum(axes.vary(hi, "tp") * xi, "tp")
        y.backward(cot)
        return y.detach(), xi.grad, hi.grad

    before = cuda_op.LAUNCHES["sum"]
    got = run()
    torch.cuda.synchronize()
    launched = cuda_op.LAUNCHES["sum"] - before
    want = _op_excluded(run)
    assert launched >= 2 * (ranks - 1)  # the forward's and backward's folds
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)


def test_mesh_a_flash_launches(dev):
    """A dp 2 x pp 2 x tp 2 forward with 2 microbatches launches the flash
    forward (M + S - 1) x L / S times, one launch over every rank, and
    its backward as many dq and dkv launches."""
    import numpy as np

    from ompi_release_tpu_torch.models import transformer as tfm
    from ompi_release_tpu_torch.parallel.mesh_axes import build_parallel_mesh

    cfg = tfm.ModelConfig(vocab=256, d_model=128, n_layers=4, n_heads=4,
                          head_dim=32, d_ff=256, max_seq=256,
                          microbatches=2)
    mesh = build_parallel_mesh(dp=2, pp=2, tp=2)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), dev)
    for t in [params["embed"], params["ln_f"], *params["layers"].values()]:
        t.requires_grad_(True)
    rng = np.random.RandomState(0)
    tokens = torch.as_tensor(rng.randint(0, 256, size=(8, 256)), device=dev)
    targets = torch.roll(tokens, -1, dims=1)
    cuda_op.reset_launches()
    loss = tfm.sharded_loss(cfg, mesh, params, tokens, targets)
    torch.cuda.synchronize()
    per_fwd = (2 + 2 - 1) * (cfg.n_layers // 2)
    assert cuda_op.LAUNCHES["flash_fwd"] == per_fwd
    loss.backward()
    torch.cuda.synchronize()
    assert cuda_op.LAUNCHES["flash_bwd_dq"] == per_fwd
    assert cuda_op.LAUNCHES["flash_bwd_dkv"] == per_fwd
    assert abs(float(loss) - np.log(cfg.vocab)) < 1.0


# ---------------------------------------------------------------------------
# ring_fold: the tuned ring allreduce's two passes as one kernel
# ---------------------------------------------------------------------------

def _interpreted_sum():
    """SUM's arithmetic under another op object: the ring bodies keep
    their interpreted passes for it (``spmd.ring_on_kernel`` claims by
    object)."""
    from ompi_release_tpu_torch import ops

    return ops.user_op("sum_interpreted", lambda a, b: a + b,
                       identity=lambda d: 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 3, 5, 8, 9, 16])
@pytest.mark.parametrize("alg,total,param", [
    ("ring", 1, 0), ("ring", 7, 0), ("ring", 37, 0), ("ring", 1001, 0),
    ("ring", 20, 0), ("ring", 1 << 16, 0), ("pipelined", 37, 2),
    ("pipelined", 1001, 3), ("segmented", 37, 5), ("segmented", 1001, 100),
    ("segmented", 1001, 16), ("segmented", 64, 3), ("segmented", 96, 6),
    ("segmented", (1 << 18) + 8, 1 << 14)])
def test_ring_fold_is_its_twin_and_the_interpreted_ring(dev, alg, total,
                                                        param, n, dtype):
    """The kernel against its twin and against the interpreted ring of
    the same body on the card, bitwise, through the bodies (which must
    take the kernel: one launch each) and called directly, aligned and
    at an element offset (the scalar path)."""
    from ompi_release_tpu_torch import ops
    from ompi_release_tpu_torch.coll import pipeline, spmd

    def body(x, op):
        if alg == "ring":
            return spmd.allreduce_ring(x, op, n)
        if alg == "pipelined":
            return pipeline.allreduce_ring_pipelined(x, op, n, param)
        return spmd.allreduce_segmented_ring(x, op, n, param)

    g = torch.Generator(device=dev).manual_seed(total * 31 + n)
    base = torch.randn(n * total + 1, generator=g, device=dev)
    base = (base * torch.exp2(torch.randint(-8, 9, base.shape, generator=g,
                                            device=dev).float())).to(dtype)
    seg = max(param, n) if alg == "segmented" else total
    if -(-total // seg) <= 1:
        seg = total
    view = torch.int32 if dtype is torch.float32 else torch.int16
    for x in (base[:-1].view(n, total), base[1:].view(n, total)):
        want = body(x, _interpreted_sum())
        twin = cuda_op._plain_ring_fold(x, n, seg, -(-seg // n))
        before = cuda_op.LAUNCHES["ring_fold"]
        got = body(x, ops.SUM)
        direct = cuda_op.ring_fold(x.contiguous(), n, seg, -(-seg // n))
        torch.cuda.synchronize()
        assert cuda_op.LAUNCHES["ring_fold"] - before == 2
        for t in (got, direct, twin):
            assert t.dtype is dtype and t.shape == x.shape
            assert torch.equal(t.view(view), want.view(view))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nbytes", [64 << 10, 4 << 20, (16 << 20) + 64])
def test_ring_fold_in_a_frozen_plan_replay(tuned, dtype, nbytes):
    """The tuned allreduce's frozen plan replays the kernel: every replay
    is bitwise the interpreted ring of the same body (SUM's arithmetic
    under an op the kernel does not claim), and ``op_ring_fold_launches``
    rises by one a replayed call."""
    from ompi_release_tpu_torch.mca import pvar as tpvar

    g = torch.Generator(device=tuned.device).manual_seed(nbytes)
    x = torch.randn(8, nbytes // 4, generator=g,
                    device=tuned.device).to(dtype)
    want = tuned.allreduce(x, _interpreted_sum())
    outs = [tuned.allreduce(x) for _ in range(2)]  # interpreted, capture
    frozen = [e["frozen"] for e in _plans(tuned)
              if e.get("frozen") is not None
              and e["frozen"].graph is not None
              and e["frozen"].launches.get("ring_fold")]
    assert len(frozen) == 1 and frozen[0].graph is not None
    pv = tpvar.PVARS.lookup("op_ring_fold_launches")
    for _ in range(3):
        before = pv.read()
        outs.append(tuned.allreduce(x))
        assert pv.read() - before == 1
    view = torch.int32 if dtype is torch.float32 else torch.int16
    for o in outs:
        assert torch.equal(o.view(view), want.view(view))


@pytest.mark.parametrize("nbytes", [64 << 10, (16 << 20) + 64])
def test_op_excluded_ring_takes_no_kernel(tuned, nbytes):
    """``--mca op ^cuda`` keeps the tuned ring on its interpreted passes
    (the op layer's claim, ``cuda_op.claims_ring``): no ``ring_fold``
    launch in the interpreted call, the capture or a replay, and the
    plain passes give the kernel's bits."""
    g = torch.Generator(device=tuned.device).manual_seed(nbytes)
    x = torch.randn(8, nbytes // 4, generator=g, device=tuned.device)
    before = cuda_op.LAUNCHES["ring_fold"]
    kernel = tuned.allreduce(x)
    assert cuda_op.LAUNCHES["ring_fold"] - before == 1
    before = cuda_op.LAUNCHES["ring_fold"]
    plain = _op_excluded(lambda: [tuned.allreduce(x) for _ in range(3)])
    torch.cuda.synchronize()
    assert cuda_op.LAUNCHES["ring_fold"] == before
    for o in plain:
        assert torch.equal(o.view(torch.int32), kernel.view(torch.int32))


def test_ring_fold_raises_on_what_the_kernel_does_not_take(dev):
    x = torch.ones(8, 64, device=dev)
    with pytest.raises(MPIError, match="contiguous"):
        cuda_op.ring_fold(x.t().contiguous().t(), 8, 64, 8)
    with pytest.raises(MPIError, match="float32/bfloat16"):
        cuda_op.ring_fold(torch.ones(8, 64, dtype=torch.int32, device=dev),
                          8, 64, 8)
    with pytest.raises(MPIError, match="ring_fold"):
        cuda_op.ring_fold(x, 4, 64, 16)  # leading axis is not n
    with pytest.raises(MPIError, match="ring_fold"):
        cuda_op.ring_fold(x, 8, 64, 7)  # chunks do not cover the segment
    # a CPU tensor takes the twin: no launch
    cuda_op.reset_launches()
    cpu = torch.arange(16.0).view(8, 2)
    assert torch.equal(cuda_op.ring_fold(cpu, 8, 2, 1),
                       cuda_op._plain_ring_fold(cpu, 8, 2, 1))
    assert cuda_op.LAUNCHES["ring_fold"] == 0
