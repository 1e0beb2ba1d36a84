"""The ring allreduce's one-kernel fold (``cuda_op.ring_fold``) held
against the interpreted ring on the CPU.

On the card the tuned ring allreduce of a SUM runs both passes as one
kernel that folds each element in its chunk's ring order
(``csrc/ring_ops.cu``); its plain twin ``cuda_op._plain_ring_fold``
repeats that fold. Here the twin must equal ``spmd.allreduce_ring``,
``spmd.allreduce_segmented_ring`` and
``pipeline.allreduce_ring_pipelined`` BITWISE, called directly and
through the bodies' own kernel route (the twin standing in for the
kernel, so the segment and chunk lengths the bodies pass are checked
too). Inputs are random signed values of spread magnitudes, so in f32
and in bf16 (rounded after every step) another order gives other bits;
the test checks that it does. The twin and the bodies' kernel route are
also held to the JAX package's tuned ring, pipelined and segmented
allreduce on the same inputs, whose digests the card test
``test_kernel_is_the_jax_ring`` holds the kernel to. The kernel itself is
held to the twin and the interpreted ring on the card
(``tests/test_torch_cuda_kernels.py``).
"""

import types

import numpy as np
import pytest
import torch

from ompi_release_tpu_torch import ops
from ompi_release_tpu_torch.coll import pipeline, spmd
from ompi_release_tpu_torch.ops import cuda_op

#: (algorithm, elements a rank, segment parameter): the plain ring's
#: parameter is unused, the pipelined ring's is its segment count, the
#: segmented ring's its segment length in elements (a partial last
#: segment in each; (1001, 100) and (37, 5) also chunks that are no
#: multiple of a 16-byte vector; (64, 3) a segment shorter than n)
SHAPES = [("ring", 1, 0), ("ring", 7, 0), ("ring", 37, 0), ("ring", 1001, 0),
          ("pipelined", 37, 2), ("pipelined", 1001, 3),
          ("segmented", 37, 5), ("segmented", 1001, 100),
          ("segmented", 1001, 16), ("segmented", 64, 3)]


def _inputs(n, total, dtype, seed):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((n, total)) * 2.0 ** rng.integers(-8, 9,
                                                                 (n, total))
    return torch.from_numpy(vals.astype(np.float32)).to(dtype)


def _interpreted(alg, x, n, param):
    if alg == "ring":
        return spmd.allreduce_ring(x, ops.SUM, n)
    if alg == "pipelined":
        return pipeline.allreduce_ring_pipelined(x, ops.SUM, n, param)
    return spmd.allreduce_segmented_ring(x, ops.SUM, n, param)


def _fold_args(alg, n, total, param):
    """(seg, chunk) of the kernel's fold for this body: the segmented
    ring's own segment when it splits, the whole buffer otherwise."""
    seg = max(param, n) if alg == "segmented" else total
    if alg == "segmented" and -(-total // seg) <= 1:
        seg = total
    return seg, -(-seg // n)


def _bits(t):
    return t.view(torch.int32 if t.dtype is torch.float32 else torch.int16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 3, 5, 8])
@pytest.mark.parametrize("alg,total,param", SHAPES)
def test_plain_ring_fold_is_the_interpreted_ring(monkeypatch, alg, total,
                                                 param, n, dtype):
    x = _inputs(n, total, dtype, seed=total * 31 + n)
    want = _interpreted(alg, x, n, param)
    seg, chunk = _fold_args(alg, n, total, param)
    got = cuda_op._plain_ring_fold(x, n, seg, chunk)
    assert got.dtype is dtype and got.shape == x.shape
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(x), _bits(_inputs(n, total, dtype,
                                                seed=total * 31 + n)))
    # the bodies' kernel route, the twin in the kernel's place
    calls = []

    def kernel(xk, nk, segk, chunkk):
        calls.append((nk, segk, chunkk))
        return cuda_op._plain_ring_fold(xk, nk, segk, chunkk)

    monkeypatch.setattr(spmd, "ring_on_kernel", lambda x, op: True)
    monkeypatch.setattr(cuda_op, "ring_fold", kernel)
    routed = _interpreted(alg, x, n, param)
    assert calls == [(n, seg, chunk)]
    assert torch.equal(_bits(routed), _bits(want))
    if total >= 37 and n >= 3:
        # the order matters: the fold one chunk over gives other bits
        other = cuda_op._plain_ring_fold(x.roll(1, 0), n, seg, chunk)
        assert not torch.equal(_bits(other), _bits(want))


def _on_card(dtype=torch.float32):
    """What the selection reads of a CUDA tensor (this host has none)."""
    return types.SimpleNamespace(is_cuda=True, dtype=dtype)


@pytest.mark.parametrize("case,takes", [
    ("sum", True), ("sum[cuda]", True), ("bf16", True), ("cpu", False),
    ("max", False), ("prod", False), ("user op named sum", False),
    ("int32", False), ("sum, op ^cuda", False),
    ("sum[cuda], op ^cuda", False)])
def test_selection_claims_only_sum_on_the_card(monkeypatch, case, takes):
    """The claim is the op layer's (``cuda_op.claims_ring``): SUM by
    object in f32 or bf16, and none while ``--mca op ^cuda`` excludes
    the CUDA op component."""
    from ompi_release_tpu_torch.mca import var as tvar

    x, op = _on_card(), ops.SUM
    if case.startswith("sum[cuda]"):
        op = cuda_op.make_cuda_sum()
    elif case == "bf16":
        x = _on_card(torch.bfloat16)
    elif case == "cpu":
        x = torch.ones(8, 4)
    elif case == "max":
        op = ops.MAX
    elif case == "prod":
        op = ops.PROD
    elif case == "user op named sum":
        op = ops.user_op("sum", lambda a, b: a + b)
    elif case == "int32":
        x = _on_card(torch.int32)
    if case.endswith("op ^cuda"):
        tvar.set_value("op", "^cuda")
    try:
        assert spmd.ring_on_kernel(x, op) is takes
    finally:
        tvar.VARS.unset("op")
    assert spmd.ring_on_kernel(_on_card(), ops.SUM)  # the exclusion undone
    if isinstance(x, torch.Tensor):
        # the CPU keeps the interpreted passes: no kernel is called
        def kernel(*a):
            raise AssertionError("the CPU took the ring kernel")

        monkeypatch.setattr(cuda_op, "ring_fold", kernel)
        xs = _inputs(8, 37, torch.float32, seed=5)
        out = spmd.allreduce_segmented_ring(xs, ops.SUM, 8, 5)
        assert torch.equal(_bits(out), _bits(
            cuda_op._plain_ring_fold(xs, 8, 8, 1)))


@pytest.mark.parametrize("bad", ["rows", "chunk", "seg"])
def test_ring_fold_refuses_what_it_cannot_fold(bad):
    from ompi_release_tpu_torch.utils.errors import MPIError

    x = torch.ones(4, 10)
    n, seg, chunk = {"rows": (3, 10, 4), "chunk": (4, 10, 2),
                     "seg": (4, 0, 1)}[bad]
    with pytest.raises(MPIError, match="ring_fold"):
        cuda_op.ring_fold(x, n, seg, chunk)


# ---------------------------------------------------------------------------
# against the JAX package: its tuned ring allreduces on the same inputs
# ---------------------------------------------------------------------------

#: (tuned algorithm, its cvars, the body and segment parameter the port
#: runs for it at 8 ranks x 1001 elements): the pipelined ring splits
#: 4004 (f32) or 2002 (bf16) bytes a rank into 1 KiB segments, the
#: segmented ring rings 1 KiB segments independently
JAX_CASES = {
    "ring": ("ring", {}),
    "ring_pipelined": ("ring", {"coll_pipeline_segsize": 1024}),
    "segmented_ring": ("segmented_ring", {"coll_tuned_segment_size": 1024}),
}
JAX_COUNT = 1001

#: SHA-256 of the bytes of the JAX package's tuned allreduce of
#: :func:`_jax_inputs` on its 8-device CPU mesh, so that the card, which
#: runs no JAX, holds the kernel to the JAX package's own bits; kept
#: true on the CPU by ``test_twin_is_the_jax_ring``
JAX_RING_SHA256 = {
    ("ring", "torch.float32"):
        "c0dabd94ad4743b18837ee6f008cb203b8124b1ca4922e92dd4dcd0290f26ba2",
    ("ring", "torch.bfloat16"):
        "0ea87010aa897fc0a0c897f13bf12b0c8c37cc84c8f54bdd2586e6b35825ca4c",
    ("ring_pipelined", "torch.float32"):
        "c0dabd94ad4743b18837ee6f008cb203b8124b1ca4922e92dd4dcd0290f26ba2",
    ("ring_pipelined", "torch.bfloat16"):
        "0ea87010aa897fc0a0c897f13bf12b0c8c37cc84c8f54bdd2586e6b35825ca4c",
    ("segmented_ring", "torch.float32"):
        "743c91ff96d3e834a30e90ec338d3af14a0efb62b1e69e378ba775a5ef0f3de7",
    ("segmented_ring", "torch.bfloat16"):
        "0994dcd6b9ead5d82f9e3f2fd7159dee3e7469e5db117ec0130cf15a67f5ff4c",
}


def _jax_inputs(dtype):
    """Rank-stacked (8, 1001) values of magnitudes 2^-6..2^6 and both
    signs, so that another order of the adds gives other bits."""
    rng = np.random.default_rng(2025)
    vals = (rng.normal(size=(8, JAX_COUNT))
            * np.exp2(rng.uniform(-6, 6, size=(8, JAX_COUNT))))
    return torch.from_numpy(vals.astype(np.float32)).to(dtype)


def _fold_of(case, dtype):
    """(body, segment parameter, seg, chunk) the port folds ``case`` with."""
    n, total = 8, JAX_COUNT
    item = torch.tensor([], dtype=dtype).element_size()
    if case == "segmented_ring":
        param = 1024 // item
        seg = max(param, n)
        return "segmented", param, seg, -(-seg // n)
    if case == "ring_pipelined":
        return "pipelined", -(-total * item // 1024), total, -(-total // n)
    return "ring", 0, total, -(-total // n)


def _sha256(t):
    import hashlib

    return hashlib.sha256(_bits(t.contiguous()).numpy().tobytes()).hexdigest()


@pytest.fixture(scope="module")
def jax_tuned():
    """The JAX package's WORLD on its CPU mesh, duplicated under tuned."""
    import ompi_release_tpu as jmpi
    from ompi_release_tpu.mca import var as jvar

    world = jmpi.init()
    jvar.set_value("coll", "tuned")
    try:
        comm = world.dup(name="ring_fold_parity")
    finally:
        jvar.VARS.unset("coll")
    yield comm
    comm.free()


def _jax_allreduce(comm, case, x):
    """``case`` forced in the JAX package on ``x``'s bits, as a tensor."""
    import jax.numpy as jnp
    from ompi_release_tpu.mca import var as jvar

    alg, cvars = JAX_CASES[case]
    arr = x.numpy() if x.dtype is torch.float32 \
        else _bits(x).numpy().view(jnp.bfloat16)
    jvar.set_value("coll_tuned_allreduce_algorithm", alg)
    for k, v in cvars.items():
        jvar.set_value(k, v)
    try:
        out = np.asarray(comm.allreduce(arr))
    finally:
        for k in ["coll_tuned_allreduce_algorithm", *cvars]:
            jvar.VARS.unset(k)
    bits = torch.from_numpy(out.view(np.int32 if out.itemsize == 4
                                     else np.int16).copy())
    return bits.view(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(JAX_CASES))
def test_twin_is_the_jax_ring(monkeypatch, jax_tuned, case, dtype):
    """The twin, and each body's kernel route with the twin in the
    kernel's place, bitwise the JAX package's tuned ring on the same
    inputs; the digest the card test holds the kernel to is that of the
    JAX package's result."""
    x = _jax_inputs(dtype)
    want = _jax_allreduce(jax_tuned, case, x)
    body, param, seg, chunk = _fold_of(case, dtype)
    assert torch.equal(_bits(cuda_op._plain_ring_fold(x, 8, seg, chunk)),
                       _bits(want))
    calls = []

    def kernel(xk, nk, segk, chunkk):
        calls.append((nk, segk, chunkk))
        return cuda_op._plain_ring_fold(xk, nk, segk, chunkk)

    monkeypatch.setattr(spmd, "ring_on_kernel", lambda x, op: True)
    monkeypatch.setattr(cuda_op, "ring_fold", kernel)
    assert torch.equal(_bits(_interpreted(body, x, 8, param)), _bits(want))
    assert calls == [(8, seg, chunk)]
    assert _sha256(want) == JAX_RING_SHA256[(case, str(dtype))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(JAX_CASES))
def test_kernel_is_the_jax_ring(case, dtype):
    """On the card: the tuned body's one ``ring_fold`` launch, and the
    kernel called directly, give the JAX package's bits (its digest) and
    the twin's on the CPU, on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    x = _jax_inputs(dtype)
    body, param, seg, chunk = _fold_of(case, dtype)
    xd = x.cuda()
    before = cuda_op.LAUNCHES["ring_fold"]
    outs = [_interpreted(body, xd, 8, param),
            cuda_op.ring_fold(xd, 8, seg, chunk)]
    torch.cuda.synchronize()
    assert cuda_op.LAUNCHES["ring_fold"] - before == 2
    twin = cuda_op._plain_ring_fold(x, 8, seg, chunk)
    for o in outs:
        assert torch.equal(_bits(o.cpu()), _bits(twin))
        assert _sha256(o.cpu()) == JAX_RING_SHA256[(case, str(dtype))]
