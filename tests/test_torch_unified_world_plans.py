"""The two parity gaps of the spanning world closed, with frozen plans:
a bf16 SUM allreduce and a non-exact f32 SUM allreduce at 4 MiB per
rank (seeded normals, so the fold order shows in the bits), through the
JAX package's ``Job`` and the port's (2 workers x 4 ranks, ``tuned``
selected in both, the harness of ``tests/test_torch_unified_world.py``).

Each case runs once fully interpreted (``coll_compiled=0``), once
recording its frozen wire plan and twice replaying it, under the auto
inter schedule and under recursive doubling (whose plans the port's C
executor fires). In-app every leg is bitwise the interpreted one and
near the numpy sum; across packages the dumps are compared bitwise, leg
by leg. At 4 MiB the folds run through the op framework's large-SUM
path (``stream_axpy``'s plain twin on the host).
"""

import numpy as np
import pytest

from test_torch_unified_world import PARITY_MCA, _assert_bitwise, _parity

BODY = """
OUT = {}
world = init()
rt = Runtime.current()
off = rt.local_rank_offset
n = world.size
E = 1 << 20  # 4 MiB of f32 per rank; bf16 at 2E: 4 MiB as well
rng = np.random.default_rng(16)
f32 = rng.standard_normal((n, E)).astype(np.float32)
b16 = (rng.standard_normal((n, 2 * E)) * 8).astype(ml_dtypes.bfloat16)
CASES = {"f32_4MiB": (f32, np.float32), "bf16_4MiB": (b16, None)}
for alg in ("auto", "recursive_doubling"):
    mca_var.set_value("hier_inter_algorithm", alg)
    try:
        for key, (full, _) in CASES.items():
            x = full[off:off + 4]
            mca_var.set_value("coll_compiled", 0)
            want = npy(world.allreduce(x))
            mca_var.VARS.unset("coll_compiled")
            legs = [npy(world.allreduce(x)) for _ in range(3)]
            for leg in legs:  # record, replay, replay: bitwise
                assert leg.tobytes() == want.tobytes(), (alg, key)
            ref = full.astype(np.float64).sum(axis=0)
            got = want[0].astype(np.float64) if key == "f32_4MiB" else \\
                want[0].view(ml_dtypes.bfloat16).astype(np.float64)
            # bf16: 7 folds at 8 significant bits, |sum| up to ~100
            rtol, atol = (1e-4, 1e-4) if key == "f32_4MiB" else (0.05, 1.0)
            np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)
            OUT[f"{alg}_{key}_interpreted"] = want[0]
            OUT[f"{alg}_{key}_replayed"] = legs[-1][0]
            if PKG == "torch":
                from ompi_release_tpu_torch.coll import plan as _cp

                sts = [s for k, s in _cp._span_states.items()
                       if k[0] == world.cid and k[1][0] == "allreduce"
                       and k[1][1][1] == tuple(x.shape)
                       and k[1][1][2].endswith(str(x.dtype))]
                assert len(sts) == 1, list(_cp._span_states)
                if alg == "recursive_doubling":
                    assert sts[0].last == "native", (key, sts[0].why)
                else:
                    assert sts[0].last in ("native", "planned"), key
    finally:
        mca_var.VARS.unset("hier_inter_algorithm")
world.barrier()
mpi.finalize()
"""


@pytest.fixture(scope="module")
def plan_dumps(tmp_path_factory):
    return _parity(tmp_path_factory, BODY, "plans", mca=PARITY_MCA)


@pytest.mark.parametrize("alg", ["auto", "recursive_doubling"])
@pytest.mark.parametrize("key", ["f32_4MiB", "bf16_4MiB"])
@pytest.mark.parametrize("leg", ["interpreted", "replayed"])
def test_spanning_allreduce_bitwise_the_jax_package(plan_dumps, alg, key,
                                                     leg):
    _assert_bitwise(plan_dumps, f"{alg}_{key}_{leg}")


def test_the_inputs_are_not_exact(plan_dumps):
    """Non-exact inputs: the folded f32 bits differ from the correctly
    rounded exact sum on some elements, so the bitwise comparisons
    above pin the fold order, not just the values."""
    rng = np.random.default_rng(16)
    full = rng.standard_normal((8, 1 << 20)).astype(np.float32)
    exact = full.astype(np.float64).sum(axis=0).astype(np.float32)
    got = plan_dumps["torch"][0]["auto_f32_4MiB_interpreted"]
    assert got.dtype == np.float32 and got.shape == (1 << 20,)
    assert got.tobytes() != exact.tobytes()
