"""The port's parallelism strategies (``ompi_release_tpu_torch/parallel``
at axes > 1) held against the JAX package on the 8-device CPU mesh.

Every case of ``tests/test_parallel.py`` runs on both packages from the
same numpy inputs: the JAX body under ``shard_map`` over a 1-D mesh, the
port's body inside a ``ParallelMesh`` of the same axis over the stacked
layout (every rank a virtual rank of the CPU, a per-rank value one
tensor with the mesh axes as leading dims). Each is held to the JAX
test's own bound against its dense reference, and the two packages to
the same bound against each other: tp 2e-5, xent 1e-5, pipeline
gradients 1e-4 / 1e-5, ring attention 2e-4, ep 1e-4. The axis
collectives themselves (psum over one axis and over a tuple, in f32 and
bf16, pmean, all_gather, psum_scatter, all_to_all tiled and not,
ppermute, axis_index) are held BITWISE against ``lax``'s: XLA's CPU
all-reduce folds linearly in rank order, the tuple's first axis
outermost, and accumulates bf16 in f32, as ``parallel/axes.py`` does.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as JP

from ompi_release_tpu.parallel import cp as jcp, dp as jdp, ep as jep
from ompi_release_tpu.parallel import pp as jpp, sp as jsp, tp as jtp
from ompi_release_tpu.parallel import zero as jzero
from ompi_release_tpu_torch.parallel import axes, cp, dp, ep, pp, sp, tp
from ompi_release_tpu_torch.parallel import zero
from ompi_release_tpu_torch.parallel.mesh_axes import (
    P, ParallelMesh, build_parallel_mesh,
)

CPU = torch.device("cpu")


def mesh1d(n, name):
    return Mesh(np.array(jax.devices()[:n]), (name,))


def smap(fn, mesh, in_specs, out_specs):
    return jax.jit(
        jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                      out_specs=out_specs, check_vma=False)
    )


def tmesh(n, name):
    return ParallelMesh(shape={name: n}, device=CPU)


def stacked(mesh, *pairs):
    """Each (numpy array, spec) as the port's stacked views."""
    return [mesh.stack(torch.from_numpy(np.ascontiguousarray(a)), s)
            for a, s in pairs]


def np_of(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.detach().numpy()


def rank_view(mesh, x, coord):
    """Rank ``coord``'s slice of the stacked ``x`` (index 0 along a
    leading dim the value is invariant over)."""
    return x[tuple(0 if x.shape[i] == 1 else coord.get(n, 0)
                   for i, n in enumerate(mesh.names))]


# -- the axis collectives, bitwise against lax ------------------------------

def _rand(shape, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape) * np.exp(rng.randn(*shape) * 4)
    return x.astype(dtype)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_psum_bitwise(n, dtype):
    x = _rand((n, 3, 50), n)
    jx = jnp.asarray(x).astype(dtype)
    got_j = smap(lambda v: lax.psum(v, "a"), mesh1d(n, "a"), (JP("a"),),
                 JP("a"))(jx)
    m = tmesh(n, "a")
    (t,) = stacked(m, (x, P("a")))
    t = t.to(getattr(torch, dtype))
    with m:
        got_t = axes.psum(t, "a")
    assert got_t.shape == (1, 1, 3, 50)  # invariant over the axis
    want = np.asarray(got_j.astype(jnp.float32)).reshape(n, 1, 3, 50)[0]
    np.testing.assert_array_equal(np_of(got_t)[0], want)


@pytest.mark.parametrize("order", [("a", "c"), ("c", "a"), ("a", "b", "c")])
def test_psum_over_axis_tuple_bitwise(order):
    x = _rand((2, 2, 2, 40), 3)
    jm = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2), ("a", "b", "c"))
    got_j = smap(lambda v: lax.psum(v, order), jm, (JP("a", "b", "c"),),
                 JP("a", "b", "c"))(x)
    m = ParallelMesh(shape={"a": 2, "b": 2, "c": 2}, device=CPU)
    (t,) = stacked(m, (x, P("a", "b", "c")))
    with m:
        got_t = axes.psum(t, order)
    full = m.unstack(got_t.expand(2, 2, 2, 1, 1, 1, 40), P("a", "b", "c"))
    np.testing.assert_array_equal(np_of(full), np.asarray(got_j))


def test_pmean_and_axis_index():
    n = 4
    x = _rand((n, 16), 5)
    jm = mesh1d(n, "a")
    got_j = smap(lambda v: lax.pmean(v, "a") + lax.axis_index("a"), jm,
                 (JP("a"),), JP("a"))(x)
    m = tmesh(n, "a")
    (t,) = stacked(m, (x, P("a")))
    with m:
        got_t = axes.pmean(t, "a") + axes.axis_index("a", 2)
    np.testing.assert_array_equal(np_of(m.unstack(got_t, P("a"))),
                                  np.asarray(got_j))


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("tiled", [False, True])
def test_all_gather_bitwise(axis, tiled):
    n = 4
    x = _rand((n * 3, 5), 6)
    got_j = smap(lambda v: lax.all_gather(v, "a", axis=axis, tiled=tiled),
                 mesh1d(n, "a"), (JP("a"),), JP())(x)
    m = tmesh(n, "a")
    (t,) = stacked(m, (x, P("a")))
    with m:
        got_t = axes.all_gather(t, "a", axis=axis, tiled=tiled)
    assert got_t.shape[0] == 1
    np.testing.assert_array_equal(np_of(got_t)[0], np.asarray(got_j))


@pytest.mark.parametrize("dim", [0, 1])
def test_psum_scatter_bitwise(dim):
    n = 4
    x = _rand((n * 8, 12), 7)
    got_j = smap(lambda v: lax.psum_scatter(v, "a", scatter_dimension=dim,
                                            tiled=True),
                 mesh1d(n, "a"), (JP("a"),), JP("a"))(x)
    m = tmesh(n, "a")
    (t,) = stacked(m, (x, P("a")))
    with m:
        got_t = axes.psum_scatter(t, "a", scatter_dimension=dim, tiled=True)
    np.testing.assert_array_equal(np_of(m.unstack(got_t, P("a"))),
                                  np.asarray(got_j))


@pytest.mark.parametrize("split,concat", [(0, 0), (0, 1), (1, 0), (1, 2),
                                          (2, 1)])
@pytest.mark.parametrize("tiled", [False, True])
def test_all_to_all_bitwise(split, concat, tiled):
    n = 4
    shape = [4, 4, 4]
    x = _rand((n * shape[0],) + tuple(shape[1:]), 8 + split)
    got_j = smap(lambda v: lax.all_to_all(v, "a", split, concat, tiled=tiled),
                 mesh1d(n, "a"), (JP("a"),), JP("a"))(x)
    m = tmesh(n, "a")
    (t,) = stacked(m, (x, P("a")))
    with m:
        got_t = axes.all_to_all(t, "a", split_axis=split,
                                concat_axis=concat, tiled=tiled)
    np.testing.assert_array_equal(np_of(m.unstack(got_t, P("a"))),
                                  np.asarray(got_j))


def test_ppermute_bitwise():
    n = 4
    x = _rand((n, 6), 9)
    perm = [(0, 2), (2, 1), (1, 0)]  # rank 3 sends nothing, receives zeros
    got_j = smap(lambda v: lax.ppermute(v, "a", perm), mesh1d(n, "a"),
                 (JP("a"),), JP("a"))(x)
    m = tmesh(n, "a")
    (t,) = stacked(m, (x, P("a")))
    with m:
        got_t = axes.ppermute(t, "a", perm)
    np.testing.assert_array_equal(np_of(m.unstack(got_t, P("a"))),
                                  np.asarray(got_j))


def test_psum_vary_autograd_is_the_transpose():
    """psum's gradient broadcasts; vary's folds: for y = psum(vary(x) * w)
    the gradient of x is psum(w), of w the broadcast x."""
    n = 4
    m = tmesh(n, "a")
    x = torch.randn(1, 5, dtype=torch.float64, requires_grad=True)
    w = torch.randn(n, 5, dtype=torch.float64, requires_grad=True)
    with m:
        y = axes.psum(axes.vary(x, "a") * w, "a")
    y.sum().backward()
    torch.testing.assert_close(x.grad, w.detach().sum(0, keepdim=True))
    torch.testing.assert_close(w.grad, x.detach().expand(n, 5))


def test_collectives_are_identity_at_size_one():
    x = torch.randn(3, 4)
    assert axes.psum(x, "tp") is x
    with build_parallel_mesh(devices=[CPU]):
        assert axes.psum(x, ("dp", "tp")) is x
        assert axes.axis_index("dp") == 0
        assert axes.axis_size_or_1("tp") == 1


# -- tp ---------------------------------------------------------------------

class TestTensorParallel:
    def test_column_row_pair_matches_dense(self):
        n = 4
        rng = np.random.RandomState(0)
        x = rng.randn(6, 16).astype(np.float32)
        w1 = rng.randn(16, 32).astype(np.float32)
        w2 = rng.randn(32, 16).astype(np.float32)
        b2 = rng.randn(16).astype(np.float32)

        def body(x, w1s, w2s, b2):
            h = jtp.column_parallel(x, w1s, axis_name="tp")
            h = jax.nn.relu(h)
            return jtp.row_parallel(h, w2s, b2, axis_name="tp")

        want = np.asarray(smap(body, mesh1d(n, "tp"),
                               (JP(), JP(None, "tp"), JP("tp", None), JP()),
                               JP())(x, w1, w2, b2))
        m = tmesh(n, "tp")
        args = stacked(m, (x, P()), (w1, P(None, "tp")), (w2, P("tp", None)),
                       (b2, P()))
        with m:
            h = torch.relu(tp.column_parallel(args[0], args[1]))
            out = tp.row_parallel(h, args[2], args[3])
        got = np_of(m.unstack(out, P()))
        ref = np.maximum(x @ w1, 0) @ w2 + b2
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

    def test_column_gather_output(self):
        n = 4
        x = np.random.RandomState(1).randn(3, 8).astype(np.float32)
        w = np.random.RandomState(2).randn(8, 12).astype(np.float32)
        want = np.asarray(smap(
            lambda x, w: jtp.column_parallel(x, w, axis_name="tp",
                                             gather_output=True),
            mesh1d(n, "tp"), (JP(), JP(None, "tp")), JP())(x, w))
        m = tmesh(n, "tp")
        xs, ws = stacked(m, (x, P()), (w, P(None, "tp")))
        with m:
            out = tp.column_parallel(xs, ws, gather_output=True)
        got = np_of(m.unstack(out, P()))
        np.testing.assert_allclose(got, x @ w, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

    def test_row_scatter_output(self):
        n = 4
        rng = np.random.RandomState(3)
        h = rng.randn(8, 16).astype(np.float32)
        w = rng.randn(16, 6).astype(np.float32)
        want = np.asarray(smap(
            lambda h, w: jtp.row_parallel(h, w, axis_name="tp",
                                          scatter_output=True),
            mesh1d(n, "tp"), (JP(None, "tp"), JP("tp", None)),
            JP("tp"))(h, w))
        m = tmesh(n, "tp")
        hs, ws = stacked(m, (h, P(None, "tp")), (w, P("tp", None)))
        with m:
            out = tp.row_parallel(hs, ws, scatter_output=True)
        got = np_of(m.unstack(out, P("tp")))
        np.testing.assert_allclose(got, h @ w, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

    def test_vocab_parallel_embedding(self):
        n = 4
        table = np.random.RandomState(3).randn(20, 8).astype(np.float32)
        ids = np.array([0, 5, 7, 19, 12], np.int32)
        want = np.asarray(smap(
            lambda i, t: jtp.vocab_parallel_embedding(i, t, axis_name="tp"),
            mesh1d(n, "tp"), (JP(), JP("tp", None)), JP())(ids, table))
        m = tmesh(n, "tp")
        i_s, t_s = stacked(m, (ids, P()), (table, P("tp", None)))
        with m:
            out = tp.vocab_parallel_embedding(i_s, t_s)
        got = np_of(m.unstack(out, P()))
        np.testing.assert_allclose(got, table[ids], rtol=1e-6)
        np.testing.assert_array_equal(got, want)

    def test_vocab_parallel_logits(self):
        n = 4
        rng = np.random.RandomState(4)
        h = rng.randn(5, 8).astype(np.float32)
        table = rng.randn(16, 8).astype(np.float32)
        want = np.asarray(smap(
            lambda h, t: jtp.vocab_parallel_logits(h, t, axis_name="tp"),
            mesh1d(n, "tp"), (JP(), JP("tp", None)), JP())(h, table))
        m = tmesh(n, "tp")
        hs, ts = stacked(m, (h, P()), (table, P("tp", None)))
        with m:
            out = tp.vocab_parallel_logits(hs, ts)
        got = np_of(m.unstack(out, P()))
        np.testing.assert_allclose(got, h @ table.T, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_vocab_parallel_xent_matches_dense(self):
        n = 4
        rng = np.random.RandomState(4)
        h = rng.randn(5, 8).astype(np.float32)
        table = rng.randn(16, 8).astype(np.float32)
        tgt = np.array([1, 15, 7, 0, 9], np.int32)
        want = np.asarray(smap(
            lambda h, t, y: jtp.vocab_parallel_xent(h, t, y, axis_name="tp"),
            mesh1d(n, "tp"), (JP(), JP("tp", None), JP()), JP())(
                h, table, tgt))
        m = tmesh(n, "tp")
        hs, ts, ys = stacked(m, (h, P()), (table, P("tp", None)), (tgt, P()))
        with m:
            out = tp.vocab_parallel_xent(hs, ts, ys)
        got = np_of(m.unstack(out, P()))
        logits = h @ table.T
        ref = (np.log(np.exp(logits - logits.max(-1, keepdims=True))
                      .sum(-1)) + logits.max(-1)
               - logits[np.arange(5), tgt])
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_xent_gradient_matches_jax(self):
        """The loss's gradient through pmax_nograd, psum and vary: the
        table's and h's gradients against jax.grad of the shard_map'd
        loss (out_specs P(): one copy of the sum differentiated)."""
        n = 4
        rng = np.random.RandomState(5)
        h = rng.randn(5, 8).astype(np.float32)
        table = rng.randn(16, 8).astype(np.float32)
        tgt = np.array([1, 15, 7, 0, 9], np.int32)
        f = jax.shard_map(
            lambda h, t, y: jnp.sum(jtp.vocab_parallel_xent(
                h, t, y, axis_name="tp")),
            mesh=mesh1d(n, "tp"), in_specs=(JP(), JP("tp", None), JP()),
            out_specs=JP())
        jg_h, jg_t = jax.grad(f, argnums=(0, 1))(h, table, tgt)
        m = tmesh(n, "tp")
        ht = torch.from_numpy(h).requires_grad_(True)
        tt = torch.from_numpy(table).requires_grad_(True)
        with m:
            out = tp.vocab_parallel_xent(m.stack(ht, P()),
                                         m.stack(tt, P("tp", None)),
                                         m.stack(torch.from_numpy(tgt), P()))
        out.sum().backward()
        np.testing.assert_allclose(ht.grad.numpy(), np.asarray(jg_h),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jg_t),
                                   rtol=1e-5, atol=1e-5)


# -- dp / zero --------------------------------------------------------------

class TestDataParallel:
    def test_bucketed_allreduce_matches_psum(self):
        n = 8
        rng = np.random.RandomState(5)
        grads = {
            "a": rng.randn(n, 3, 4).astype(np.float32),
            "b": rng.randn(n, 7).astype(np.float32),
            "c": rng.randn(n, 2000).astype(np.float32),  # > bucket
            "d": rng.randn(n, 5).astype(np.int32).astype(np.float32),
        }
        want = smap(lambda g: jdp.allreduce_gradients(
            g, "dp", mean=True, bucket_bytes=64),
            mesh1d(n, "dp"), (JP("dp"),), JP("dp"))(grads)
        m = tmesh(n, "dp")
        gs = {k: m.stack(torch.from_numpy(v), P("dp")) for k, v in
              grads.items()}
        with m:
            out = dp.allreduce_gradients(gs, "dp", mean=True,
                                         bucket_bytes=64)
        for k in grads:
            got = np_of(m.unstack(out[k].expand(gs[k].shape), P("dp")))
            ref = np.broadcast_to(grads[k].mean(0, keepdims=True),
                                  grads[k].shape)
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(got, np.asarray(want[k]))

    def test_replicate_check_detects_divergence(self):
        n = 4
        same = np.ones((n, 3), np.float32)
        div = same.copy()
        div[2] += 0.5
        m = tmesh(n, "dp")
        for arr, want in ((same, 0.0), (div, 0.5)):
            (x,) = stacked(m, (arr, P("dp")))
            with m:
                got = dp.replicate_check(x, "dp")
            assert float(got.max()) == pytest.approx(want)


class TestZero:
    def test_shard_unshard_roundtrip(self):
        n = 4
        p = np.random.RandomState(6).randn(3, 5).astype(np.float32)
        m = tmesh(n, "dp")
        (pt,) = stacked(m, (p, P()))
        with m:
            shard = zero.shard_like(pt, "dp")
            out = zero.unshard_params(shard, (3, 5), "dp")
        assert shard.shape == (n, 4)  # 15 elems padded to 16, 4 per rank
        np.testing.assert_array_equal(np_of(m.unstack(out, P())), p)

    def test_zero_sgd_step_matches_dense_sgd(self):
        n = 4
        rng = np.random.RandomState(7)
        params = {"w": rng.randn(6, 3).astype(np.float32)}
        grads = rng.randn(n, 6, 3).astype(np.float32)
        lr = 0.1

        def jupdate(gs, state, ps):
            return jax.tree.map(lambda g: -lr * g, gs), state

        want = smap(lambda p, g: jzero.zero_step(p, {"w": g}, None, jupdate,
                                                 "dp")[0],
                    mesh1d(n, "dp"), (JP(), JP("dp")), JP())(
            params, grads)

        def tupdate(gs, state, ps):
            return {k: -lr * g for k, g in gs.items()}, state

        m = tmesh(n, "dp")
        pw, gw = stacked(m, (params["w"], P()), (grads, P("dp")))
        with m:
            out, _ = zero.zero_step({"w": pw}, {"w": gw[:, 0]}, None,
                                    tupdate, "dp")
        got = np_of(m.unstack(out["w"], P()))
        ref = params["w"] - lr * grads.mean(0)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, np.asarray(want["w"]), rtol=1e-6,
                                   atol=1e-7)


# -- pp ---------------------------------------------------------------------

def _stage_j(w, x):
    return jnp.tanh(x @ w)


def _stage_t(w, x):
    return torch.tanh(torch.matmul(x, w))


def _mse_t(out, t):
    return ((out - t) ** 2).mean(dim=tuple(range(1, out.dim())))


class TestPipeline:
    def test_pipeline_matches_sequential(self):
        n, mbs = 4, 8
        rng = np.random.RandomState(8)
        ws = rng.randn(n, 6, 6).astype(np.float32) * 0.3
        x = rng.randn(mbs, 2, 6).astype(np.float32)
        want = np.asarray(smap(
            lambda w, x: jpp.pipeline(_stage_j, w[0], x, axis_name="pp")[None],
            mesh1d(n, "pp"), (JP("pp"), JP()), JP("pp"))(ws, x))[n - 1]
        m = tmesh(n, "pp")
        wt, xt = stacked(m, (ws, P("pp")), (x, P()))
        with m:
            out = pp.pipeline(_stage_t, wt[:, 0], xt)
        got = np_of(out)[n - 1]
        ref = x
        for s in range(n):
            ref = np.tanh(ref @ ws[s])
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        # the other stages hold zeros, as the reference's outputs do
        assert not np_of(out)[:n - 1].any()

    @pytest.mark.parametrize("remat", [False, True])
    def test_pipeline_loss_grads_flow_to_all_stages(self, remat):
        n, mbs = 4, 4
        rng = np.random.RandomState(9)
        ws = rng.randn(n, 4, 4).astype(np.float32) * 0.3
        x = rng.randn(mbs, 2, 4).astype(np.float32)
        y = rng.randn(mbs, 2, 4).astype(np.float32)

        def loss_of(w_stage, x, y):
            return jpp.pipeline_loss(
                _stage_j, lambda out, t: jnp.mean((out - t) ** 2),
                w_stage, x, y, axis_name="pp", remat=remat)

        def body(w, x, y):
            loss, g = jax.value_and_grad(loss_of)(w[0], x, y)
            return loss[None], g[None]

        jloss, jg = smap(body, mesh1d(n, "pp"), (JP("pp"), JP(), JP()),
                         (JP("pp"), JP("pp")))(ws, x, y)
        m = tmesh(n, "pp")
        wt = torch.from_numpy(ws).requires_grad_(True)
        xt, yt = stacked(m, (x, P()), (y, P()))
        with m:
            loss = pp.pipeline_loss(_stage_t, _mse_t, m.stack(wt, P("pp"))[
                :, 0], xt, yt, remat=remat)
        # jax.grad of a per-rank loss inside shard_map seeds every rank:
        # the port differentiates the sum of the stages' copies
        loss.sum().backward()
        g = wt.grad.numpy()
        assert loss.shape == (n,)
        for s in range(n):  # every stage got its own nonzero gradient
            assert np.abs(g[s]).max() > 0
        np.testing.assert_allclose(np_of(loss), np_of(loss)[0])

        def dense_loss(ws_all):
            h = x
            for s in range(n):
                h = jnp.tanh(h @ ws_all[s])
            return jnp.mean((h - y) ** 2)

        ref_g = np.asarray(jax.grad(dense_loss)(ws))
        np.testing.assert_allclose(np_of(loss)[0], float(dense_loss(ws)),
                                   rtol=1e-5)
        np.testing.assert_allclose(g, ref_g, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g, np.asarray(jg), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np_of(loss), np.asarray(jloss),
                                   rtol=1e-5)


# -- sp / cp ----------------------------------------------------------------

class TestSequenceParallel:
    def test_reshard_roundtrip(self):
        n = 4
        x = np.random.RandomState(10).randn(16, 8, 4).astype(np.float32)
        m = tmesh(n, "sp")
        (xt,) = stacked(m, (x, P("sp")))
        with m:
            h = sp.seq_to_heads(xt)
            assert h.shape == (n, 16, 2, 4)  # full sequence, H/n heads
            out = sp.heads_to_seq(h)
        np.testing.assert_array_equal(np_of(m.unstack(out, P("sp"))), x)

    def test_seq_to_heads_matches_jax(self):
        n = 4
        x = np.random.RandomState(11).randn(16, 8, 4).astype(np.float32)
        want = np.asarray(smap(lambda v: jsp.seq_to_heads(v, axis_name="sp"),
                               mesh1d(n, "sp"), (JP("sp"),),
                               JP(None, "sp"))(x))
        m = tmesh(n, "sp")
        (xt,) = stacked(m, (x, P("sp")))
        with m:
            out = sp.seq_to_heads(xt)
        np.testing.assert_array_equal(np_of(m.unstack(out, P(None, "sp"))),
                                      want)

    def test_ulysses_matches_local_attention(self):
        n = 4
        s, h, d = 16, 8, 4
        rng = np.random.RandomState(11)
        q, k, v = (rng.randn(s, h, d).astype(np.float32) for _ in range(3))

        def jattn(q, k, v):
            o = jcp.local_flash_attention(
                q.transpose(1, 0, 2), k.transpose(1, 0, 2),
                v.transpose(1, 0, 2))
            return o.transpose(1, 0, 2)

        def tattn(q, k, v):
            o = cp.local_flash_attention(*(t.transpose(-3, -2)
                                           for t in (q, k, v)))
            return o.transpose(-3, -2)

        want = np.asarray(smap(
            lambda q, k, v: jsp.ulysses_attention(q, k, v, jattn,
                                                  axis_name="sp"),
            mesh1d(n, "sp"), (JP("sp"),) * 3, JP("sp"))(q, k, v))
        m = tmesh(n, "sp")
        qt, kt, vt = stacked(m, (q, P("sp")), (k, P("sp")), (v, P("sp")))
        with m:
            out = sp.ulysses_attention(qt, kt, vt, tattn)
        got = np_of(m.unstack(out, P("sp")))
        ref = np_of(tattn(*(torch.from_numpy(a) for a in (q, k, v))))
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


class TestRingAttention:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("n", [2, 4])
    def test_ring_matches_local(self, causal, n):
        h, s, d = 2, 16, 8
        rng = np.random.RandomState(12)
        q, k, v = (rng.randn(h, s, d).astype(np.float32) for _ in range(3))
        spec = JP(None, "sp")
        want = np.asarray(smap(
            lambda q, k, v: jcp.ring_attention(q, k, v, axis_name="sp",
                                               causal=causal),
            mesh1d(n, "sp"), (spec,) * 3, spec)(q, k, v))
        m = tmesh(n, "sp")
        qt, kt, vt = stacked(m, *((a, P(None, "sp")) for a in (q, k, v)))
        with m:
            out = cp.ring_attention(qt, kt, vt, causal=causal)
        got = np_of(m.unstack(out, P(None, "sp")))
        ref = np_of(cp.local_flash_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), causal=causal))
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


# -- ep ---------------------------------------------------------------------

class TestExpertParallel:
    def _run_both(self, n, x, router, scales, cf, expert_t, expert_j):
        def run(x, r, s):
            o, a = jep.moe_layer(x[0], r, expert_j, s, axis_name="ep",
                                 capacity_factor=cf)
            return o, a[None]

        jout, jaux = smap(run, mesh1d(n, "ep"), (JP("ep"), JP(), JP("ep")),
                          (JP("ep"), JP("ep")))(x, router, scales)
        m = tmesh(n, "ep")
        xt, rt, st = stacked(m, (x, P("ep")), (router, P()),
                             (scales, P("ep")))
        with m:
            out, aux = ep.moe_layer(xt[:, 0], rt, expert_t, (st,),
                                    capacity_factor=cf)
        return (np_of(out), np_of(aux).reshape(-1),
                np.asarray(jout).reshape(out.shape), np.asarray(jaux))

    def test_moe_matches_dense_when_capacity_ample(self):
        n = 4
        t, dmodel, e = 8, 6, 8
        rng = np.random.RandomState(13)
        x = rng.randn(n, t, dmodel).astype(np.float32)
        router = rng.randn(dmodel, e).astype(np.float32)
        scales = np.arange(1, e + 1, dtype=np.float32)[:, None]
        out, aux, jout, jaux = self._run_both(
            n, x, router, scales, float(e),
            lambda ps, tok: tok * ps[0][..., None],
            lambda s, tok: tok * s)
        for r in range(n):
            logits = x[r] @ router
            probs = np.exp(logits - logits.max(-1, keepdims=True))
            probs /= probs.sum(-1, keepdims=True)
            pick = probs.argmax(-1)
            ref = x[r] * scales[pick, 0][:, None] * probs[
                np.arange(t), pick][:, None]
            np.testing.assert_allclose(out[r], ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(out, jout, rtol=1e-4, atol=1e-4)
        assert aux.shape == (1,)  # pmean'd: invariant over ep
        np.testing.assert_allclose(np.broadcast_to(aux, jaux.shape), jaux,
                                   rtol=1e-4)

    def test_moe_capacity_drops_tokens_to_zero(self):
        n = 2
        t, dmodel, e = 8, 4, 2
        rng = np.random.RandomState(14)
        x_pos = np.abs(rng.randn(n, t, dmodel).astype(np.float32)) + 1.0
        router = np.zeros((dmodel, e), np.float32)
        router[:, 0] = 10.0 / dmodel  # everyone onto expert 0
        out, _, jout, _ = self._run_both(
            n, x_pos, router, np.zeros((e, 1), np.float32), 0.5,
            lambda ps, tok: tok, lambda s, tok: tok)
        zero_rows = (np.abs(out) < 1e-12).all(-1)
        assert zero_rows.any() and not zero_rows.all()
        np.testing.assert_array_equal(zero_rows,
                                      (np.abs(jout) < 1e-12).all(-1))
        np.testing.assert_allclose(out, jout, rtol=1e-4, atol=1e-4)


# -- mesh builder -----------------------------------------------------------

def test_build_parallel_mesh_axes():
    mesh = build_parallel_mesh(dp=2, tp=4, devices=[CPU])
    assert mesh.shape == {"dp": 2, "pp": 1, "sp": 1, "ep": 1, "tp": 4}
    assert mesh.size == 8 and mesh.device == CPU
    assert build_parallel_mesh(dp=2, pp=2, tp=2,
                               devices=[CPU] * 8).size == 8
    with pytest.raises(ValueError):
        build_parallel_mesh(dp=3, tp=4, devices=[CPU, CPU])
    with pytest.raises(ValueError):
        build_parallel_mesh(dp=0, devices=[CPU])


@pytest.mark.parametrize("spec", [P(), P("dp"), P(None, "tp"),
                                  P(("dp", "ep"), "sp"), P("pp", None, "tp")])
def test_stack_matches_addressable_shards(spec):
    """Each rank's stacked view equals the data JAX's NamedSharding puts
    on the device at the same mesh coordinate, bitwise."""
    from jax.sharding import NamedSharding

    from ompi_release_tpu.parallel.mesh_axes import (
        build_parallel_mesh as jbuild,
    )

    axes_ = dict(dp=2, pp=1, sp=2, ep=1, tp=2) if "pp" not in str(spec) \
        else dict(dp=2, pp=2, sp=1, ep=1, tp=2)
    shape = (8, 4, 6)[:max(len(spec), 2)]
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    jm = jbuild(devices=jax.devices()[:8], **axes_)
    arr = jax.device_put(x, NamedSharding(jm, JP(*spec)))
    m = build_parallel_mesh(devices=[CPU], **axes_)
    st = m.stack(torch.from_numpy(x), spec)
    coord_of = {d: dict(zip(jm.axis_names, idx))
                for idx, d in np.ndenumerate(jm.devices)}
    for shard in arr.addressable_shards:
        np.testing.assert_array_equal(
            np_of(rank_view(m, st, coord_of[shard.device])),
            np.asarray(shard.data))
    np.testing.assert_array_equal(np_of(m.unstack(st, spec)), x)


# -- the bench's mesh suite -------------------------------------------------

def test_mesh_suite_specs_match_bench_py():
    """bench.py's ``_mesh_specs`` at its off-TPU sizes on the 8-device CPU
    mesh and the port's over 8 virtual ranks: the same lines in the same
    order, with the same bytes and ceiling."""
    import bench as jbench
    from ompi_release_tpu_torch import bench as tbench

    jspecs, jceil = jbench._mesh_specs(jax, jnp, jax.devices()[:8], False)
    tspecs, tceil = tbench._mesh_specs("cpu", small=True)
    assert [s["name"] for s in tspecs] == [s["name"] for s in jspecs]
    assert [s["nbytes"] for s in tspecs] == [s["nbytes"] for s in jspecs]
    assert tceil == tuple(jceil)
    for t, j in zip(tspecs, jspecs):
        assert t.get("hops") == j.get("hops")
        assert "ws" not in t  # a collective always reports a ratio


@pytest.mark.parametrize("name", ["ring_4hop", "allreduce_64KiB",
                                  "bcast_f32", "allgather_bf16",
                                  "reduce_scatter_block_f32",
                                  "alltoall_i32_torus"])
def test_mesh_suite_loops_match_bench_py(name):
    """Each mesh-suite loop's checksum after k = 3 iterations on random
    inputs equals bench.py's loop on the same inputs (f32 rel 1e-6: the
    psum folds in lax's order; the data moves are exact)."""
    import bench as jbench
    from ompi_release_tpu_torch import bench as tbench

    jspec = {s["name"]: s for s in jbench._mesh_specs(
        jax, jnp, jax.devices()[:8], False)[0]}[name]
    tspec = {s["name"]: s for s in tbench._mesh_specs("cpu", small=True)[
        0]}[name]
    (targ,) = tspec["args"]
    rng = np.random.RandomState(3)
    vals = rng.randint(-8, 8, size=tuple(targ.shape))
    t_in = torch.from_numpy(vals).to(targ.dtype)
    (jarg,) = jspec["args"]
    j_in = jax.device_put(jnp.asarray(vals.reshape(jarg.shape),
                                      dtype=jarg.dtype), jarg.sharding)
    got = float(tspec["loop"](t_in, 3))
    want = float(jspec["loop"](j_in, 3))
    assert got == pytest.approx(want, rel=1e-6)
