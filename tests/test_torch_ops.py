"""The port's op framework and streaming-kernel twins against the JAX
package.

On the CPU the CUDA kernels' wrappers take their plain PyTorch twins
(the kernels themselves are held against the same twins on the card by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``). The JAX
side runs the Pallas kernels in interpret mode, as ``tests/test_ops.py``
does. Tolerances, stated per kernel:

- SUM (``_pallas_sum_fn`` / ``sum_``): bitwise, f32 and bf16 — one IEEE
  add, rounded once, in both;
- axpy f32: rtol=1e-6 (the tolerance of the reference's own parity
  check, ``bench.py:303``; the kernel may be compiled with or without a
  fused multiply-add on either side);
- bf16 axpy/scale: within 1 bf16 ulp of the JAX result (the port
  widens to f32 and rounds once; JAX may round the product first);
- scale f32: rtol=1e-6 (one rounded multiply: expected bitwise).
"""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

from ompi_release_tpu import ops as jops
from ompi_release_tpu.ops import pallas_op
from ompi_release_tpu_torch import ops as tops
from ompi_release_tpu_torch.mca import var as tvar
from ompi_release_tpu_torch.ops import cuda_op, flash_attention
from ompi_release_tpu_torch.utils.errors import MPIError

SIZES = [1, 4097, 3000, (17, 33)]


def _pair(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        a, b = a.astype(ml_dtypes.bfloat16), b.astype(ml_dtypes.bfloat16)
    return a, b


def _t(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _np(t):
    if t.dtype is torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _within_bf16_ulp(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    # one bf16 ulp at the expected value: 2^(exponent - 7)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want) / ulp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SIZES)
def test_sum_bitwise_vs_pallas(shape, dtype):
    a, b = _pair(shape, dtype, 1)
    want = np.asarray(pallas_op._pallas_sum_fn(jnp.asarray(a),
                                               jnp.asarray(b)))
    got = _np(cuda_op.sum_(_t(a), _t(b)))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SIZES)
def test_axpy_vs_pallas(shape, dtype):
    a, acc = _pair(shape, dtype, 2)
    want = np.asarray(pallas_op.axpy(jnp.asarray(a), jnp.asarray(acc), 0.5))
    got = _np(cuda_op.axpy(_t(a), _t(acc), 0.5))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        _within_bf16_ulp(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SIZES)
def test_scale_vs_pallas(shape, dtype):
    x, _ = _pair(shape, dtype, 3)
    want = np.asarray(pallas_op.scale(jnp.asarray(x), 1.0001))
    got = _np(cuda_op.scale(_t(x), 1.0001))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        _within_bf16_ulp(got, want)


def test_cpu_tensors_never_count_launches():
    cuda_op.reset_launches()
    a = torch.ones(100)
    cuda_op.sum_(a, a)
    cuda_op.axpy(a, a, 2.0)
    cuda_op.scale(a, 2.0)
    cuda_op.transpose(a.view(10, 10))
    cuda_op.chain_hop(torch.ones(cuda_op.CHAIN_TILE))
    q = torch.ones(2, 10, 8)
    out, lse = flash_attention.flash_forward(q, q, q, True)
    flash_attention.flash_backward(q, q, q, out, lse, q, True)
    cuda_op.ring_fold(torch.ones(4, 10), 4, 10, 3)
    assert cuda_op.LAUNCHES == {"sum": 0, "axpy": 0, "scale": 0,
                                "transpose": 0, "chain": 0, "flash_fwd": 0,
                                "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                                "ring_fold": 0}


def test_bench_loops_match_pallas_loops():
    rows, cols, k = 8, 128, 3
    a = np.random.default_rng(4).standard_normal((rows, cols)).astype(
        np.float32)
    jaxpy = float(pallas_op.make_axpy_loop(rows, cols)(jnp.asarray(a), k))
    taxpy = float(cuda_op.make_axpy_loop(rows, cols)(torch.from_numpy(a), k))
    np.testing.assert_allclose(taxpy, jaxpy, rtol=1e-5)
    jscale = float(pallas_op.make_scale_loop(rows, cols)(jnp.asarray(a), k))
    tscale = float(cuda_op.make_scale_loop(rows, cols)(torch.from_numpy(a),
                                                      k))
    np.testing.assert_allclose(tscale, jscale, rtol=1e-5)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc means no kernel — never a silent fallback."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_op, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(MPIError, match="nvcc not found"):
        cuda_op.build()


# ---------------------------------------------------------------------------
# op framework
# ---------------------------------------------------------------------------

def test_op_framework_components():
    names = {c.NAME for c in tops.OP_FRAMEWORK.components()}
    assert names == {"torch", "cuda"}
    assert tops.resolve(tops.SUM) is tops.SUM


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_component_claims_large_sum_singleton(dtype):
    got = tops.resolve(tops.SUM, dtype, 64 << 20)
    assert got.name == "sum[cuda]"
    assert got.commutative and got.identity_for(dtype) == 0
    assert tops.resolve(tops.SUM, dtype, 4 << 20) is got  # one object
    a = torch.arange(600, dtype=torch.float32).to(dtype)
    b = torch.ones(600, dtype=dtype)
    assert torch.equal(got(a, b), a + b)


def test_cuda_component_declines():
    assert tops.resolve(tops.SUM, torch.float32, (4 << 20) - 1) is tops.SUM
    assert tops.resolve(tops.SUM, torch.int32, 64 << 20) is tops.SUM
    assert tops.resolve(tops.SUM, torch.float64, 64 << 20) is tops.SUM
    assert tops.resolve(tops.MAX, torch.float32, 64 << 20) is tops.MAX


def test_threshold_is_tunable_and_exclusion_disables():
    try:
        tvar.VARS.apply_cli([("op_cuda_threshold", "64")])
        assert tops.resolve(tops.SUM, torch.float32, 128).name == "sum[cuda]"
        tvar.VARS.apply_cli([("op", "^cuda")])
        assert tops.resolve(tops.SUM, torch.float32, 128) is tops.SUM
    finally:
        tvar.VARS.unset("op_cuda_threshold")
        tvar.VARS.unset("op")


def test_both_packages_claim_the_same_shapes():
    for dt_j, dt_t in ((np.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16),
                       (np.int32, torch.int32)):
        for nbytes in (1024, 4 << 20, 64 << 20):
            j = jops.resolve(jops.SUM, dt_j, nbytes).name
            t = tops.resolve(tops.SUM, dt_t, nbytes).name
            assert j.replace("pallas", "cuda") == t, (dt_t, nbytes)


def test_predefined_ops_and_identities_match_jax():
    assert set(tops.PREDEFINED_OPS) == set(jops.PREDEFINED_OPS)
    for name, top in tops.PREDEFINED_OPS.items():
        jop = jops.PREDEFINED_OPS[name]
        assert top.commutative == jop.commutative
        assert top.is_pair_op == jop.is_pair_op
        assert (top.identity is None) == (jop.identity is None)
    for name in ("max", "min", "band", "sum", "prod"):
        for dt_j, dt_t in ((np.float32, torch.float32),
                           (np.int32, torch.int32)):
            if name == "band" and dt_t is torch.float32:
                continue
            want = np.asarray(jops.PREDEFINED_OPS[name].identity_for(dt_j))
            got = tops.PREDEFINED_OPS[name].identity_for(dt_t)
            assert float(got) == float(want), (name, dt_t)


@pytest.mark.parametrize("name", ["sum", "prod", "max", "min", "band",
                                  "bor", "bxor", "land", "lor", "lxor"])
def test_predefined_combiners_match_jax(name):
    rng = np.random.default_rng(5)
    a = rng.integers(-9, 9, 64).astype(np.int32)
    b = rng.integers(-9, 9, 64).astype(np.int32)
    want = np.asarray(jops.PREDEFINED_OPS[name](jnp.asarray(a),
                                                jnp.asarray(b)))
    got = tops.PREDEFINED_OPS[name](torch.from_numpy(a),
                                    torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["maxloc", "minloc"])
def test_pair_ops_match_jax(op):
    rng = np.random.default_rng(6)
    va, vb = rng.integers(0, 4, (2, 50)).astype(np.float32)
    ia, ib = rng.integers(0, 9, (2, 50)).astype(np.int32)
    jv, ji = jops.PREDEFINED_OPS[op]((jnp.asarray(va), jnp.asarray(ia)),
                                     (jnp.asarray(vb), jnp.asarray(ib)))
    tv, ti = tops.PREDEFINED_OPS[op]((torch.from_numpy(va),
                                      torch.from_numpy(ia)),
                                     (torch.from_numpy(vb),
                                      torch.from_numpy(ib)))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_reduce_local_and_user_op():
    a = np.random.default_rng(7).standard_normal(5000).astype(np.float32)
    b = np.random.default_rng(8).standard_normal(5000).astype(np.float32)
    want = np.asarray(jops.reduce_local(a, b, jops.SUM))
    got = tops.reduce_local(a, b, tops.SUM).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    avg = tops.user_op("avg2", lambda x, y: (x + y) / 2)
    assert float(avg(torch.tensor(2.0), torch.tensor(4.0))) == 3.0
    assert avg.commutative and tops.resolve(avg) is avg


def test_build_compiles_and_hashes_every_source(tmp_path, monkeypatch):
    """``cuda_op.build()`` compiles every ``csrc/*.cu`` (one ``nvcc -c``
    each, then one link) into a library named by the hash of all
    sources: a change to any one source, or a source added, gives a new
    library; an unchanged set is reused without a compile. A stand-in
    ``nvcc`` records its calls (the real one exists only on the card's
    machine)."""
    csrc, build, calls = tmp_path / "csrc", tmp_path / "build", \
        tmp_path / "calls.txt"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a\n")
    (csrc / "b.cu").write_text("// b\n")
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {calls}\n'
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo built > "$2"\n'
        'echo "ptxas info    : Used 8 registers"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(cuda_op, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(cuda_op, "BUILD_DIR", str(build))
    monkeypatch.setattr(cuda_op, "_nvcc", lambda: str(fake))

    def compiled():
        lines = calls.read_text().splitlines() if calls.exists() else []
        calls.unlink(missing_ok=True)
        return sorted(ln.split()[-1].rsplit("/", 1)[-1] for ln in lines
                      if " -c " in f" {ln} ")

    first = cuda_op.build()
    assert compiled() == ["a.cu", "b.cu"]
    assert open(cuda_op.ptxas_log_path(first)).read().count("ptxas") == 2
    assert cuda_op.build() == first and compiled() == []  # reused
    (csrc / "b.cu").write_text("// b, changed\n")
    second = cuda_op.build()
    assert second != first and compiled() == ["a.cu", "b.cu"]
    (csrc / "c.cu").write_text("// c\n")
    third = cuda_op.build()
    assert third not in (first, second)
    assert compiled() == ["a.cu", "b.cu", "c.cu"]
    assert sorted(p.name for p in build.iterdir()
                  if p.suffix == ".so") == sorted(
        p.rsplit("/", 1)[-1] for p in (first, second, third))


def test_library_name_hashes_the_headers(tmp_path, monkeypatch):
    """The library's name covers ``csrc/*.cuh`` beside ``csrc/*.cu``: in
    a copy of the port's sources, an edit to the shared wgmma header
    alone names another library, though the compiled sources are the
    same files."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_op.CSRC_DIR, csrc)
    monkeypatch.setattr(cuda_op, "CSRC_DIR", str(csrc))
    header = csrc / "wgmma_sm90.cuh"
    assert str(header) in cuda_op.headers()
    assert str(header) not in cuda_op.sources()  # never compiled alone
    srcs, first = cuda_op.sources(), cuda_op.library_name()
    assert cuda_op.library_name() == first  # pure: same files, same name
    header.write_text(header.read_text() + "// edited\n")
    assert cuda_op.sources() == srcs
    assert cuda_op.library_name() != first
