"""The small-message fusion buffer of the PyTorch port held against the
JAX package (``coll/fusion.py``): flush policy, pvars, the shared
bucket planner, and the fused results.

Each case of ``TestFusion``/``TestPlanBuckets`` in
``tests/test_coll_pipeline.py`` runs here on both packages. On tuned
communicators (named algorithms, one fixed order) the fused results are
BITWISE equal to JAX's and to the flat allreduce of each bucket's
concatenation in the port itself; on the fused component they are
exact on integer-valued inputs.
"""

import contextlib
import time

import numpy as np
import pytest
import torch

import ompi_release_tpu as jmpi
from ompi_release_tpu import ops as jops
from ompi_release_tpu.coll.fusion import FusionBuffer as JFusionBuffer
from ompi_release_tpu.coll.fusion import plan_buckets as jplan
from ompi_release_tpu.mca import pvar as jpvar
from ompi_release_tpu.mca import var as jvar
import ompi_release_tpu_torch as tmpi
from ompi_release_tpu_torch import ops as tops
from ompi_release_tpu_torch.coll.fusion import FusionBuffer, plan_buckets
from ompi_release_tpu_torch.mca import pvar as tpvar
from ompi_release_tpu_torch.mca import var as tvar
from ompi_release_tpu_torch.runtime import runtime as trt
from ompi_release_tpu_torch.utils.errors import MPIError

N = 8
PATIENT = 10_000_000  # max delay (us) long enough never to fire here


@contextlib.contextmanager
def both(**kv):
    for k, v in kv.items():
        jvar.set_value(k, v)
        tvar.set_value(k, v)
    try:
        yield
    finally:
        for k in kv:
            jvar.VARS.unset(k)
            tvar.VARS.unset(k)


@pytest.fixture(scope="module")
def worlds():
    jworld = jmpi.init()
    trt._reset_for_tests()
    tworld = tmpi.init(cli_args=["--mca", "runtime_virtual_ranks", str(N)],
                       device="cpu")
    yield jworld, tworld
    trt._reset_for_tests()
    tvar.VARS.unset("runtime_virtual_ranks")


@pytest.fixture(scope="module")
def tuned(worlds):
    jworld, tworld = worlds
    with both(coll="tuned"):
        jc, tc = jworld.dup(name="fusion_tuned"), tworld.dup(
            name="fusion_tuned")
    yield jc, tc
    jc.free()
    tc.free()


def _per_rank(n, count, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, count))
            * np.exp2(rng.uniform(-6, 6, size=(n, count)))).astype(np.float32)


def _pvar(name):
    return tpvar.PVARS.lookup(name)


def _same(jout, tout):
    j = np.asarray(jout)
    t = tout.detach().cpu().numpy()
    assert j.shape == t.shape and j.dtype.itemsize == t.dtype.itemsize
    uint = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[
        j.dtype.itemsize]
    np.testing.assert_array_equal(j.view(uint), t.view(uint))


class TestFusion:
    def test_flush_semantics_and_parity(self, tuned):
        jc, tc = tuned
        jfb = JFusionBuffer(jc, max_delay_us=PATIENT)
        fb = FusionBuffer(tc, max_delay_us=PATIENT)
        xs = [_per_rank(N, 64, seed=10 + i) for i in range(6)]
        f0 = _pvar("coll_fusion_flushes").read()
        b0 = _pvar("coll_fusion_batched").read()
        jh = [jfb.allreduce(x) for x in xs]
        handles = [fb.allreduce(x) for x in xs]
        assert fb.pending() == 6
        assert not any(h.done for h in handles)
        assert fb.flush() == 1
        jfb.flush()
        assert fb.pending() == 0 and all(h.done for h in handles)
        assert _pvar("coll_fusion_flushes").read() - f0 == 1
        assert _pvar("coll_fusion_batched").read() - b0 == 6
        flat = tc.allreduce(torch.from_numpy(np.concatenate(xs, axis=1)))
        off = 0
        for x, h, j in zip(xs, handles, jh):
            _same(j.result(), h.result())  # the same bucket, the same ring
            assert torch.equal(h.result(), flat[:, off:off + x.shape[1]])
            off += x.shape[1]

    def test_result_forces_flush(self, worlds):
        _, tw = worlds
        fb = FusionBuffer(tw, max_delay_us=PATIENT)
        x = np.random.default_rng(20).integers(-9, 9, (N, 32)).astype(
            np.float32)
        h = fb.allreduce(x)
        assert not h.done
        out = h.result()  # correctness never waits on policy
        assert h.done and fb.pending() == 0
        np.testing.assert_array_equal(out[0].numpy(), x.sum(axis=0))

    def test_threshold_dispatches_immediately(self, worlds):
        jw, tw = worlds
        fb = FusionBuffer(tw, threshold=1024, max_delay_us=PATIENT)
        jfb = JFusionBuffer(jw, threshold=1024, max_delay_us=PATIENT)
        big = _per_rank(N, 512, seed=21)  # 2 KiB/rank >= 1 KiB
        h, jh = fb.allreduce(big), jfb.allreduce(big)
        assert h.done and jh.done and fb.pending() == 0
        np.testing.assert_allclose(h.result()[0].numpy(),
                                   np.asarray(jh.result())[0], rtol=2e-5,
                                   atol=1e-5)
        assert torch.equal(h.result(), tw.allreduce(big))

    def test_max_delay_flushes_older_pendings(self, worlds):
        _, tw = worlds
        fb = FusionBuffer(tw, max_delay_us=1000)  # 1 ms bound
        h1 = fb.allreduce(_per_rank(N, 16, seed=22))
        time.sleep(0.01)
        h2 = fb.allreduce(_per_rank(N, 16, seed=23))
        assert h1.done and not h2.done
        fb.flush()
        assert h2.done

    def test_capacity_triggers_flush(self, worlds):
        _, tw = worlds
        fb = FusionBuffer(tw, capacity=2048, max_delay_us=PATIENT)
        hs = [fb.allreduce(_per_rank(N, 256, seed=24 + i))
              for i in range(3)]  # 3 x 1 KiB > 2 KiB capacity
        assert all(h.done for h in hs)
        assert fb.pending() == 0

    def test_dtype_groups_stay_separate(self, worlds):
        _, tw = worlds
        fb = FusionBuffer(tw, max_delay_us=PATIENT)
        f0 = _pvar("coll_fusion_flushes").read()
        hf = fb.allreduce(_per_rank(N, 16, seed=30))
        hi = fb.allreduce(np.ones((N, 16), np.int32), tops.SUM)
        fb.flush()
        assert _pvar("coll_fusion_flushes").read() - f0 == 2
        assert torch.equal(hi.result()[0], torch.full((16,), N,
                                                      dtype=torch.int32))
        assert hf.done

    def test_pvar_counts_after_burst(self, worlds):
        jw, tw = worlds
        fb = FusionBuffer(tw, max_delay_us=PATIENT)
        jfb = JFusionBuffer(jw, max_delay_us=PATIENT)
        tnames = ("coll_fusion_batched", "coll_fusion_flushes",
                  "coll_fusion_bytes_saved")
        t0 = [_pvar(k).read() for k in tnames]
        j0 = [jpvar.PVARS.lookup(k).read() for k in tnames]
        n_t, elems = 16, 64
        xs = [np.full((N, elems), i, np.float32) for i in range(n_t)]
        hs = [fb.allreduce(x) for x in xs]
        jhs = [jfb.allreduce(x) for x in xs]
        fb.flush()
        jfb.flush()
        tdelta = [_pvar(k).read() - v for k, v in zip(tnames, t0)]
        jdelta = [jpvar.PVARS.lookup(k).read() - v
                  for k, v in zip(tnames, j0)]
        assert tdelta == jdelta == [n_t, 1, (n_t - 1) * elems * 4]
        for i, (h, jh) in enumerate(zip(hs, jhs)):
            _same(jh.result(), h.result())  # integer-valued: exact
            assert torch.equal(h.result()[0],
                               torch.full((elems,), float(i) * N))

    def test_communicator_exposure(self, worlds):
        _, tw = worlds
        fb = tw.fusion_buffer()
        assert fb is tw.fusion_buffer()  # one per comm
        h = tw.fused_allreduce(_per_rank(N, 16, seed=40))
        tw.fusion_buffer().flush()
        assert h.done

    def test_pair_op_dispatches_immediately(self, worlds):
        jw, tw = worlds
        vals = _per_rank(N, 8, seed=41)
        idxs = np.tile(np.arange(N)[:, None], (1, 8)).astype(np.int32)
        fb = FusionBuffer(tw, max_delay_us=PATIENT)
        h = fb.allreduce((vals, idxs), tops.MAXLOC)
        assert h.done
        mv, mi = h.result()
        np.testing.assert_array_equal(mi[0].numpy(), vals.argmax(axis=0))
        jv, ji = JFusionBuffer(jw).allreduce((vals, idxs),
                                             jops.MAXLOC).result()
        _same(jv, mv)
        _same(ji, mi)

    def test_bad_leading_axis_raises(self, worlds):
        _, tw = worlds
        with pytest.raises(MPIError):
            FusionBuffer(tw).allreduce(np.ones((N - 1, 4), np.float32))


class TestPlanBuckets:
    """The greedy same-dtype planner: the same buckets as JAX's."""

    CASES = [
        ([("a", 100, "f32"), ("b", 100, "f32"), ("c", 100, "i32"),
          ("d", 100, "f32")], 1000, [["a", "b"], ["c"], ["d"]]),
        ([("a", 600, "f32"), ("b", 600, "f32"), ("c", 600, "f32")], 1000,
         [["a"], ["b"], ["c"]]),
        ([("a", 600, "f32"), ("b", 600, "f32"), ("c", 600, "f32")], 1200,
         [["a", "b"], ["c"]]),
        ([("big", 5000, "f32")], 1000, [["big"]]),
    ]

    @pytest.mark.parametrize("case", range(len(CASES)))
    def test_planner_matches_jax(self, case):
        items, cap, want = self.CASES[case]
        assert plan_buckets(items, cap) == jplan(items, cap) == want

    def test_gradient_list_buckets_match_the_flat_allreduce(self, tuned):
        """A gradient-shaped list (norm vectors and matrices) through a
        fusion buffer whose threshold queues them all: each tensor is
        bitwise its slice of its bucket's flat allreduce, and both
        packages plan the same buckets and return the same bits."""
        jc, tc = tuned
        shapes = [(8,), (16, 8), (8,), (8, 32), (32, 8), (8,)]
        rng = np.random.default_rng(3)
        xs = [rng.normal(size=(N,) + s).astype(np.float32) for s in shapes]
        cap = 2048
        fb = FusionBuffer(tc, threshold=1 << 20, capacity=1 << 30,
                          max_delay_us=PATIENT)
        jfb = JFusionBuffer(jc, threshold=1 << 20, capacity=1 << 30,
                            max_delay_us=PATIENT)
        hs = [fb.allreduce(x) for x in xs]
        jhs = [jfb.allreduce(x) for x in xs]
        fb._capacity = jfb._capacity = cap  # plan the flush at 2 KiB
        fb.flush()
        jfb.flush()
        sizes = [x[0].size * 4 for x in xs]
        buckets = plan_buckets(((i, b, "f32") for i, b in
                                enumerate(sizes)), cap)
        assert buckets == jplan(((i, b, "f32") for i, b in
                                 enumerate(sizes)), cap)
        assert len(buckets) > 1
        for bucket in buckets:
            flat = tc.allreduce(torch.cat(
                [torch.from_numpy(xs[i]).reshape(N, -1) for i in bucket],
                dim=1))
            off = 0
            for i in bucket:
                w = xs[i][0].size
                assert torch.equal(hs[i].result().reshape(N, -1),
                                   flat[:, off:off + w])
                _same(jhs[i].result(), hs[i].result())
                off += w
