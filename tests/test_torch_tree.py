"""The port's planned whole-tree collectives (``parallel/tree.py``,
``parallel/dp.py``, ``parallel/zero.py``), the host-driven pipeline
(``parallel/pp.HostPipeline``) and ``tree.run_tree_pass``, held against
the JAX package.

The in-process cases of ``tests/test_tree.py`` on both packages: the
partition rules (regex -> spec trees, scalar leaves unpartitioned,
unmatched leaves raising, path names, the flagship's rules against its
literal table); plan units (per-dtype buckets, the cache and its
``tree_plan_cache_hits`` aggregate, the tuned resolution chain); the
BITWISE parity matrix of the SPMD passes (planned against the per-leaf
path, mixed-dtype trees with single-element leaves, over the stacked
8-rank layout) and each against JAX's pass on the 8-device CPU mesh,
bitwise; the ZeRO round trips; the host-driver ``TreeSync`` families on
the port's WORLD (8 virtual ranks on the CPU) against its per-leaf
blocking collectives, bitwise, and against JAX's ``TreeSync``;
``HostPipeline`` against its blocking leg and the ``pp.pipeline`` ring;
and the in-process leg of ``tests/test_compiled_plan.py``'s
``test_compiled_whole_tree_pass`` (one cached program per signature).
The 3-process ``TestTreeJob`` is in ``tests/test_torch_spanning_jobs.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as JP

import ompi_release_tpu as jmpi
from ompi_release_tpu.parallel import pp as jpp
from ompi_release_tpu.parallel import tree as jtree, zero as jzero
import ompi_release_tpu_torch as tmpi
from ompi_release_tpu_torch.mca import pvar
from ompi_release_tpu_torch.mca import var as mca_var
from ompi_release_tpu_torch.parallel import dp, pp, tree, zero
from ompi_release_tpu_torch.parallel.mesh_axes import P, ParallelMesh
from ompi_release_tpu_torch.runtime import runtime as trt

CPU = torch.device("cpu")
N = 8


@pytest.fixture(scope="module")
def worlds():
    jworld = jmpi.init()
    trt._reset_for_tests()
    tworld = tmpi.init(cli_args=["--mca", "runtime_virtual_ranks", str(N)],
                       device="cpu")
    yield jworld, tworld
    trt._reset_for_tests()
    mca_var.VARS.unset("runtime_virtual_ranks")


@pytest.fixture(scope="module")
def world(worlds):
    return worlds[1]


def mesh1d(n, name):
    return Mesh(np.array(jax.devices()[:n]), (name,))


def smap(fn, mesh, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def tmesh(n, name="dp"):
    return ParallelMesh(shape={name: n}, device=CPU)


def _pv(name):
    p = pvar.PVARS.lookup(name)
    v = p.read() if p is not None else 0.0
    return v if isinstance(v, dict) else float(v)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def N_(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# rules -> PartitionSpec plan
# ---------------------------------------------------------------------------

class TestPartitionRules:
    RULES = (
        (r"embed", P("tp", None)),
        (r"layers/w.*", P("pp", None, "tp")),
        (r"layers/ln\d", P("pp", None)),
    )

    def test_regex_rules_match_paths_first_wins(self):
        tree_ = {
            "embed": np.zeros((8, 4)),
            "layers": {"w1": np.zeros((2, 4, 4)),
                       "ln1": np.zeros((2, 4))},
        }
        specs = tree.match_partition_rules(self.RULES, tree_)
        assert specs["embed"] == P("tp", None)
        assert specs["layers"]["w1"] == P("pp", None, "tp")
        assert specs["layers"]["ln1"] == P("pp", None)

    def test_scalar_leaves_unpartitioned(self):
        tree_ = {"embed": np.zeros(()), "layers": {"w1": np.zeros((1,))}}
        specs = tree.match_partition_rules(self.RULES, tree_)
        assert specs["embed"] == P()
        assert specs["layers"]["w1"] == P()

    def test_unmatched_leaf_raises(self):
        with pytest.raises(ValueError, match="orphan"):
            tree.match_partition_rules(self.RULES,
                                       {"orphan": np.zeros((3, 3))})

    def test_named_tree_map_paths(self):
        names = []
        tree_ = {"a": {"b": [np.zeros(2), np.zeros(3)]}, "c": np.zeros(1)}
        tree.named_tree_map(lambda name, x: names.append(name), tree_)
        jnames = []
        jtree.named_tree_map(lambda name, x: jnames.append(name), tree_)
        assert sorted(names) == ["a/b/0", "a/b/1", "c"]
        assert names == jnames  # the same names in the same (flatten) order

    def test_rules_agree_with_jax(self):
        tree_ = {"embed": np.zeros((8, 4)), "x": np.zeros(()),
                 "layers": {"w1": np.zeros((2, 4, 4)), "w2": np.zeros((1,)),
                            "ln1": np.zeros((2, 4))}}
        jrules = tuple((pat, JP(*spec)) for pat, spec in self.RULES)
        t = tree.match_partition_rules(self.RULES, tree_)
        j = jtree.match_partition_rules(jrules, tree_)
        assert tuple(t["embed"]) == tuple(j["embed"])
        assert tuple(t["x"]) == tuple(j["x"])
        for k in tree_["layers"]:
            assert tuple(t["layers"][k]) == tuple(j["layers"][k])

    def test_model_partition_rules_match_literal_table(self):
        from ompi_release_tpu_torch.models import transformer as tfm

        for n_experts in (0, 8):
            cfg = tfm.ModelConfig(n_experts=n_experts)
            specs = tfm.param_specs(cfg)
            layers = {"ln1": P("pp", None), "wq": P("pp", None, "tp"),
                      "wk": P("pp", None, "tp"),
                      "wv": P("pp", None, "tp"),
                      "wo": P("pp", "tp", None), "ln2": P("pp", None)}
            if n_experts:
                layers.update(router=P("pp", None, None),
                              we1=P("pp", "ep", None, None),
                              we2=P("pp", "ep", None, None))
            else:
                layers.update(w1=P("pp", None, "tp"),
                              w2=P("pp", "tp", None))
            assert specs == {"embed": P("tp", None), "ln_f": P(),
                             "layers": layers}


# ---------------------------------------------------------------------------
# plan units: bucketing, caching, tuned resolution
# ---------------------------------------------------------------------------

class TestPlan:
    def test_buckets_group_by_dtype_and_capacity(self):
        sig = [((100,), "float32"), ((100,), "float32"), ((10,), "int32"),
               ((1000,), "float32"), ((2,), "float32")]
        plan = tree.plan_from_meta(sig, 1024)
        assert plan.big == [3]
        assert plan.buckets == [[0, 1], [2], [4]]
        assert plan.n_transfers() == 4
        jplan = jtree.plan_from_meta(sig, 1024)
        assert (plan.big, plan.buckets) == (jplan.big, jplan.buckets)
        assert plan.meta == jplan.meta

    def test_torch_dtypes_plan_as_numpy_names(self):
        a = tree.plan_from_meta([((5,), torch.float32), ((3,), torch.int32)],
                                512)
        b = tree.plan_from_meta([((5,), "float32"), ((3,), np.int32)], 512)
        assert a is b

    def test_zero_capacity_is_per_leaf(self):
        plan = tree.plan_from_meta([((4,), "float32")] * 3, 0)
        assert plan.big == [0, 1, 2] and plan.buckets == []

    def test_plan_cache_hits(self):
        sig = [((41,), "float32"), ((13,), "int32")]
        before = _pv("tree_plan_cache_hits")
        p1 = tree.plan_from_meta(sig, 3331)
        assert tree.plan_from_meta(sig, 3331) is p1
        assert tree.plan_from_meta(sig, 3332) is not p1
        after = _pv("tree_plan_cache_hits")
        assert after["count"] - before["count"] == 3
        assert after["sum"] - before["sum"] == 1  # exactly one hit

    def test_resolution_chain(self, tmp_path, world):
        mca_var.set_value("tree_bucket_bytes", 12345)
        try:
            assert tree.resolve_bucket_bytes(8, 1 << 20) == 12345
        finally:
            mca_var.VARS.unset("tree_bucket_bytes")
        assert tree.resolve_bucket_bytes(8, 1 << 20) == int(
            mca_var.get("dp_bucket_bytes", 4 * 1024 * 1024))
        rules = tmp_path / "rules.conf"
        rules.write_text(
            "tree_buckets  0  0        fused  65536\n"
            "tree_buckets  0  1048576  per_leaf\n")
        mca_var.set_value("coll_tuned_use_dynamic_rules", True)
        mca_var.set_value("coll_tuned_dynamic_rules_filename", str(rules))
        try:
            assert tree.resolve_bucket_bytes(8, 1024) == 65536
            assert tree.resolve_bucket_bytes(8, 2 << 20) == 0
        finally:
            mca_var.VARS.unset("coll_tuned_use_dynamic_rules")
            mca_var.VARS.unset("coll_tuned_dynamic_rules_filename")


# ---------------------------------------------------------------------------
# SPMD bitwise parity matrix: planned pass vs per-leaf, and vs JAX
# ---------------------------------------------------------------------------

def _mixed_tree(n, rng):
    return {
        "a": rng.randn(n, 3, 4).astype(np.float32),
        "b": rng.randn(n, 7).astype(np.float32),
        "big": rng.randn(n, 2000).astype(np.float32),
        "i": (rng.randn(n, 5) * 100).astype(np.int32),
        "h": rng.randn(n, 11).astype(np.float16),
        "s": rng.randn(n, 1).astype(np.float32),  # scalar-per-rank
    }


def _t_run(n, arrays, spec, fn):
    m = tmesh(n)
    st = {k: m.stack(T(v), spec) for k, v in arrays.items()}
    with m:
        return m, fn(st)


class TestSpmdBitwiseParity:
    @pytest.mark.parametrize("mean", [False, True])
    @pytest.mark.parametrize("bucket", [64, 4096, 1 << 20])
    def test_tree_allreduce_bitwise(self, mean, bucket):
        n = N
        grads = _mixed_tree(n, np.random.RandomState(0))

        def run(bb):
            return _t_run(n, grads, P("dp"), lambda g: tree.tree_allreduce(
                g, "dp", mean=mean, bucket_bytes=bb))

        m, planned = run(bucket)
        _, perleaf = run(0)
        jout = smap(lambda g: jtree.tree_allreduce(g, "dp", mean=mean,
                                                   bucket_bytes=bucket),
                    mesh1d(n, "dp"), (JP("dp"),), JP("dp"))(grads)
        for k in grads:
            assert planned[k].shape[0] == 1  # invariant over dp
            np.testing.assert_array_equal(N_(planned[k]), N_(perleaf[k]))
            np.testing.assert_array_equal(
                np.broadcast_to(N_(planned[k]), (n, 1) + grads[k].shape[1:])
                .reshape(grads[k].shape), np.asarray(jout[k]), err_msg=k)

    @pytest.mark.parametrize("mean", [False, True])
    def test_tree_reduce_scatter_bitwise(self, mean):
        n = N
        grads = _mixed_tree(n, np.random.RandomState(1))

        def run(bb):
            return _t_run(n, grads, P("dp"),
                          lambda g: tree.tree_reduce_scatter(
                              g, "dp", mean=mean, bucket_bytes=bb))

        _, planned = run(512)
        _, perleaf = run(0)
        jout = smap(lambda g: jtree.tree_reduce_scatter(
            g, "dp", mean=mean, bucket_bytes=512),
            mesh1d(n, "dp"), (JP("dp"),), JP("dp"))(grads)
        for k in grads:
            np.testing.assert_array_equal(N_(planned[k]), N_(perleaf[k]))
            np.testing.assert_array_equal(
                N_(planned[k]).reshape(-1), np.asarray(jout[k]), err_msg=k)

    def test_tree_allgather_bitwise_roundtrip(self):
        n = 4
        rng = np.random.RandomState(2)
        params = {"w": rng.randn(6, 3).astype(np.float32),  # pad path
                  "v": rng.randn(16).astype(np.float32),
                  "i": (rng.randn(5) * 9).astype(np.int32)}

        def run(bb):
            def body(p):
                shards = zero.shard_like(p, "dp")
                shapes = {k: tuple(v.shape[1:]) for k, v in p.items()}
                return zero.unshard_params(shards, shapes, "dp",
                                           bucket_bytes=bb)
            return _t_run(n, params, P(), body)

        m, planned = run(128)
        _, perleaf = run(0)
        for k in params:
            np.testing.assert_array_equal(N_(planned[k]), N_(perleaf[k]))
            np.testing.assert_array_equal(N_(m.unstack(planned[k], P())),
                                          params[k])

    def test_zero_grad_shard_roundtrip_bitwise(self):
        n = N
        rng = np.random.RandomState(3)
        grads = {"w": rng.randn(6, 3).astype(np.float32),
                 "v": rng.randn(15).astype(np.float32)}

        def run(bb):
            def body(g):
                sh = zero.shard_gradients(g, "dp", mean=False,
                                          bucket_bytes=bb)
                shapes = {k: tuple(v.shape[1:]) for k, v in g.items()}
                return zero.unshard_params(sh, shapes, "dp",
                                           bucket_bytes=bb)
            return _t_run(n, grads, P(), body)

        _, planned = run(64)
        _, perleaf = run(0)

        def jbody(g):
            sh = jzero.shard_gradients(g, "dp", mean=False, bucket_bytes=64)
            return jzero.unshard_params(
                sh, jax.tree.map(lambda x: x.shape, g), "dp",
                bucket_bytes=64)

        jout = smap(jbody, mesh1d(n, "dp"), (JP(),), JP())(grads)
        for k in grads:
            np.testing.assert_array_equal(N_(planned[k]), N_(perleaf[k]))
            np.testing.assert_array_equal(N_(planned[k])[0],
                                          np.asarray(jout[k]))

    def test_zero_step_still_matches_dense_sgd(self):
        n = 4
        rng = np.random.RandomState(7)
        params = {"w": rng.randn(6, 3).astype(np.float32)}
        grads = rng.randn(n, 6, 3).astype(np.float32)
        lr = 0.1
        m = tmesh(n)
        pw, gw = m.stack(T(params["w"]), P()), m.stack(T(grads), P("dp"))
        with m:
            out, _ = zero.zero_step(
                {"w": pw}, {"w": gw[:, 0]}, None,
                lambda gs, st, ps: ({k: -lr * g for k, g in gs.items()}, st),
                "dp", bucket_bytes=128)
        ref = params["w"] - lr * grads.mean(0)
        np.testing.assert_allclose(N_(m.unstack(out["w"], P())), ref,
                                   rtol=1e-5, atol=1e-6)

    def test_dp_allreduce_gradients_rides_tree_pass(self):
        n = N
        rng = np.random.RandomState(5)
        grads = {"a": rng.randn(n, 9).astype(np.float32)}
        before = _pv("tree_plan_cache_hits")["count"]
        _, out = _t_run(n, grads, P("dp"), lambda g: dp.allreduce_gradients(
            g, "dp", mean=True, bucket_bytes=64))
        ref = grads["a"].mean(0, keepdims=True)
        np.testing.assert_allclose(N_(out["a"])[:, 0], ref, rtol=1e-5)
        assert _pv("tree_plan_cache_hits")["count"] > before


# ---------------------------------------------------------------------------
# host-driver TreeSync: overlapped families vs blocking per-leaf
# ---------------------------------------------------------------------------

class TestTreeSyncDriver:
    def test_allreduce_bitwise_vs_blocking(self, worlds):
        jworld, world = worlds
        n = world.size
        rng = np.random.RandomState(0)
        grads = {"a": rng.randn(n, 40).astype(np.float32),
                 "b": rng.randn(n, 7).astype(np.float32),
                 "i": (rng.randn(n, 5) * 10).astype(np.int32),
                 "big": rng.randn(n, 3000).astype(np.float32)}
        out = tree.TreeSync(world, mean=False, bucket_bytes=256).issue(
            grads).wait()
        jout = jtree.TreeSync(jworld, mean=False, bucket_bytes=256).issue(
            grads).wait()
        for k in grads:
            np.testing.assert_array_equal(N_(out[k]),
                                          N_(world.allreduce(T(grads[k]))))
            # JAX's WORLD allreduce leaves its fold order to XLA
            np.testing.assert_allclose(N_(out[k]), np.asarray(jout[k]),
                                       rtol=1e-6, atol=1e-6)

    def test_allreduce_mean(self, world):
        n = world.size
        x = {"a": np.ones((n, 4), np.float32) * 3}
        out = tree.TreeSync(world, mean=True).issue(x).wait()
        np.testing.assert_allclose(N_(out["a"]), np.ones((n, 4)) * 3)

    def test_reduce_scatter_bitwise_vs_blocking(self, worlds):
        jworld, world = worlds
        n = world.size
        rng = np.random.RandomState(1)
        grads = {"a": rng.randn(n, 40).astype(np.float32),
                 "b": rng.randn(n, 7).astype(np.float32)}
        out = tree.TreeSync(world, mean=False, bucket_bytes=512) \
            .issue_reduce_scatter(grads).wait()
        jout = jtree.TreeSync(jworld, mean=False, bucket_bytes=512) \
            .issue_reduce_scatter(grads).wait()
        for k, g in grads.items():
            pad = (-g.shape[1]) % n
            gp = np.concatenate(
                [g, np.zeros((n, pad), g.dtype)], axis=1) if pad else g
            ref = N_(world.reduce_scatter_block(T(gp)))
            np.testing.assert_array_equal(N_(out[k]), ref)
            np.testing.assert_allclose(N_(out[k]), np.asarray(jout[k]),
                                       rtol=1e-6, atol=1e-6)

    def test_allgather_roundtrip_bitwise(self, world):
        n = world.size
        rng = np.random.RandomState(2)
        grads = {"a": rng.randn(n, 40).astype(np.float32),
                 "b": rng.randn(n, 7).astype(np.float32)}
        sync = tree.TreeSync(world, mean=False, bucket_bytes=512)
        shards = sync.issue_reduce_scatter(grads).wait()
        shapes = {k: (v.shape[1],) for k, v in grads.items()}
        full = sync.issue_allgather(shards, shapes).wait()
        for k in grads:
            ref = N_(world.allgather(shards[k]))
            np.testing.assert_array_equal(N_(full[k]),
                                          ref.reshape(n, -1)[:, :shapes[k][0]])

    def test_scalar_leaf_rejected(self, world):
        with pytest.raises(ValueError, match="leading"):
            tree.TreeSync(world).issue({"s": np.float32(1.0)})

    def test_mismatched_lead_rejected(self, world):
        n = world.size
        with pytest.raises(ValueError, match="leading"):
            tree.TreeSync(world).issue(
                {"a": np.ones((n, 2), np.float32),
                 "b": np.ones((n + 1, 2), np.float32)})

    def test_gradient_sync_is_tree_sync(self, world):
        assert issubclass(dp.GradientSync, tree.TreeSync)
        n = world.size
        g = {"a": np.ones((n, 6), np.float32)}
        out = dp.GradientSync(world, bucket_bytes=64).issue(g).wait()
        np.testing.assert_allclose(N_(out["a"]), np.ones((n, 6)))


# ---------------------------------------------------------------------------
# HostPipeline (driver mode: one controller runs the stages in turn)
# ---------------------------------------------------------------------------

class TestHostPipeline:
    def _run_all_stages(self, comm, weights, mbs, nonblocking):
        outs = None
        for s in range(comm.size):
            w = T(weights[s])
            r = pp.HostPipeline(
                comm, lambda x, w=w: torch.tanh(torch.as_tensor(x) @ w),
                stage=s, nonblocking=nonblocking).run(mbs)
            if s == comm.size - 1:
                outs = r
        return outs

    def test_matches_sequential_and_blocking_leg(self, world):
        n = world.size
        rng = np.random.RandomState(8)
        weights = [rng.randn(6, 6).astype(np.float32) * 0.3
                   for _ in range(n)]
        mbs = [T(rng.randn(2, 6).astype(np.float32)) for _ in range(5)]
        nb = self._run_all_stages(world, weights, mbs, True)
        bl = self._run_all_stages(world, weights, mbs, False)
        ref = [N_(x) for x in mbs]
        for s in range(n):
            ref = [np.tanh(x @ weights[s]) for x in ref]
        for a, b, r in zip(nb, bl, ref):
            np.testing.assert_array_equal(N_(a), N_(b))
            np.testing.assert_allclose(N_(a), r, rtol=1e-5, atol=1e-6)

    def test_matches_pipeline_ring(self):
        """The host schedule computes the pp.pipeline ring's function, on
        both packages."""
        n, m = 4, 6
        rng = np.random.RandomState(9)
        ws = rng.randn(n, 6, 6).astype(np.float32) * 0.3
        x = rng.randn(m, 2, 6).astype(np.float32)
        jring = np.asarray(smap(
            lambda w, xb: jpp.pipeline(lambda w_, v: jnp.tanh(v @ w_), w[0],
                                       xb, axis_name="pp")[None],
            mesh1d(n, "pp"), (JP("pp"), JP()), JP("pp"))(ws, x))[n - 1]
        tm = tmesh(n, "pp")
        with tm:
            ring = N_(pp.pipeline(lambda w_, v: torch.tanh(v @ w_),
                                  tm.stack(T(ws), P("pp"))[:, 0],
                                  tm.stack(T(x), P())))[n - 1]
        outs = [T(v) for v in x]
        for s in range(n):
            outs = pp.HostPipeline(
                _SoloComm(), lambda xb, w=T(ws[s]): torch.tanh(xb @ w),
                stage=0, nonblocking=True).run(outs)
        host = np.stack([N_(o) for o in outs])
        np.testing.assert_allclose(host, ring, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(host, jring, rtol=1e-5, atol=1e-6)

    def test_one_controller_hands_over_above_the_eager_limit(self, world):
        """At the default ``pml_eager_limit`` (1 MiB) a boundary larger
        than the limit still passes between stages one controller plays
        in turn: the nonblocking leg equals the blocking leg."""
        width = (1 << 17) + 16  # 2 rows: just over 1 MiB of f32
        mbs = [torch.full((2, width), float(k + 1)) for k in range(2)]
        half = np.float32(0.5)
        outs = {}
        for nb in (True, False):
            for s in range(world.size):
                r = pp.HostPipeline(world, lambda x: x * half, stage=s,
                                    nonblocking=nb).run(mbs)
            outs[nb] = r
        for k, (a, b) in enumerate(zip(outs[True], outs[False])):
            assert N_(a).tobytes() == N_(b).tobytes()
            np.testing.assert_array_equal(
                N_(a), np.full((2, width), (k + 1) * 0.5 ** world.size,
                               np.float32))

    def test_boundary_pvars_count(self, world):
        before = _pv("pp_boundary_msgs")
        weights = [np.eye(3, dtype=np.float32)] * world.size
        mbs = [torch.ones(2, 3)] * 4
        self._run_all_stages(world, weights, mbs, True)
        assert _pv("pp_boundary_msgs") - before == (world.size - 1) * 4


class _SoloComm:
    """1-stage comm stub: HostPipeline degenerates to a map()."""
    size = 1
    local_comm_ranks = [0]


# ---------------------------------------------------------------------------
# one cached program for a whole planned pass
# ---------------------------------------------------------------------------

def test_compiled_whole_tree_pass(worlds):
    """One cached program for a whole planned tree pass, parity with the
    per-leaf blocking collectives (and JAX's compiled pass), cached per
    signature."""
    jworld, world = worlds
    n = world.size
    t = {"w": np.arange(n * 48, dtype=np.float32).reshape(n, 48) * 0.5,
         "b": np.ones((n, 5), np.float32),
         "i": np.arange(n * 6, dtype=np.int32).reshape(n, 6)}
    out = tree.run_tree_pass(world, t, kind="allreduce",
                             bucket_bytes=1 << 20)
    jout = jtree.run_tree_pass(jworld, t, kind="allreduce",
                               bucket_bytes=1 << 20)
    for k in t:
        got = np.broadcast_to(N_(out[k]), t[k].shape)
        np.testing.assert_array_equal(got, N_(world.allreduce(T(t[k]))))
        np.testing.assert_array_equal(got, np.asarray(jout[k]))
    c0 = _pv("coll_programs_compiled")
    tree.run_tree_pass(world, t, kind="allreduce", bucket_bytes=1 << 20)
    assert _pv("coll_programs_compiled") == c0  # cached program
    with pytest.raises(ValueError):
        tree.run_tree_pass(world, t, kind="alltoall")


def test_compiled_tree_reduce_scatter(worlds):
    jworld, world = worlds
    n = world.size
    rng = np.random.RandomState(11)
    t = {"w": rng.randn(n, 30).astype(np.float32),
         "v": rng.randn(n, 9).astype(np.float32)}
    out = tree.run_tree_pass(world, t, kind="reduce_scatter", mean=True,
                             bucket_bytes=4096)
    jout = jtree.run_tree_pass(jworld, t, kind="reduce_scatter", mean=True,
                               bucket_bytes=4096)
    for k in t:
        np.testing.assert_array_equal(N_(out[k]).reshape(n, -1),
                                      np.asarray(jout[k]).reshape(n, -1))
