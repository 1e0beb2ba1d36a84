"""The port's TpuLM sharded over a mesh of virtual ranks, held against the
JAX package's sharded TpuLM on the 8-device CPU mesh.

The cases of ``tests/test_models.py`` on the same factorizations, with
the same weights (``params_from_jax`` of JAX's ``init_params``) and the
same batches, at its bounds: the loss on each of the seven
factorizations within rel 1e-4 / abs 1e-5 of JAX's sharded loss and of
the port's own one-device loss; two SGD steps' losses (rel 1e-4, then
rel 1e-3 / abs 1e-4) at dp2 x sp2 x tp2 and dp2 x pp2 x tp2 with two
microbatches, with every parameter after the steps against JAX's; the
MoE at ep = 2 (capacity factor 4.0); remat; the flash path (its plain
twin on the CPU) against ring attention on a mesh. ``shard_params``:
every rank's view of every leaf equals JAX's ``addressable_shards`` data
for the device at the same mesh coordinate, bitwise (dense and MoE on
both of ``dryrun_multichip``'s meshes). ``entry.dryrun_multichip(8)``
on the CPU covers every axis > 1, and its two factorizations' train
steps (``adamw(1e-3)``) match JAX's from JAX's weights.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding

from ompi_release_tpu.models import transformer as jtfm
from ompi_release_tpu.parallel.mesh_axes import (
    build_parallel_mesh as jbuild,
)
from ompi_release_tpu_torch import entry as tentry
from ompi_release_tpu_torch import optim
from ompi_release_tpu_torch.models import transformer as ttfm
from ompi_release_tpu_torch.parallel.mesh_axes import build_parallel_mesh

CPU = torch.device("cpu")
CFG = dict(vocab=32, d_model=16, n_layers=2, n_heads=4, head_dim=4, d_ff=32,
           max_seq=16)
FACTORIZATIONS = [
    dict(dp=2), dict(tp=2), dict(sp=2), dict(dp=2, tp=2),
    dict(dp=2, sp=2, tp=2), dict(dp=2, pp=2, tp=2), dict(pp=2, sp=2, tp=2),
]


def _ids(axes):
    return "x".join(f"{k}{v}" for k, v in axes.items())


def cfgs(**over):
    return (jtfm.ModelConfig(**CFG, dtype=jnp.float32, **over),
            ttfm.ModelConfig(**CFG, dtype=torch.float32, **over))


def make_batch(seed, b=8, s=16, vocab=32):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, size=(b, s)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def jmesh(axes):
    n = int(np.prod(list(axes.values()))) if axes else 1
    return jbuild(devices=jax.devices()[:n], **axes)


def tmesh(axes):
    return build_parallel_mesh(devices=[CPU], **axes)


def rank_view(mesh, x, coord):
    """Rank ``coord``'s slice of the stacked ``x`` (index 0 along a
    leading dim the value is invariant over)."""
    return x[tuple(0 if x.shape[i] == 1 else coord.get(n, 0)
                   for i, n in enumerate(mesh.names))]


def j_loss(cfg, axes, params, tokens, targets):
    mesh = jmesh(axes)
    sh = jtfm.make_batch_sharding(mesh)
    return float(jtfm.make_forward(cfg, mesh)(
        jtfm.shard_params(params, cfg, mesh), jax.device_put(tokens, sh),
        jax.device_put(targets, sh)))


def t_loss(cfg, axes, np_params, tokens, targets):
    return float(ttfm.make_forward(cfg, tmesh(axes))(
        ttfm.params_from_jax(np_params, cfg), tokens, targets))


def j_steps(cfg, axes, params, tokens, targets, opt):
    mesh = jmesh(axes)
    step = jtfm.make_train_step(cfg, mesh, opt)
    p = jtfm.shard_params(params, cfg, mesh)
    state = jax.jit(opt.init)(p)
    sh = jtfm.make_batch_sharding(mesh)
    tok, tgt = jax.device_put(tokens, sh), jax.device_put(targets, sh)
    p, state, l0 = step(p, state, tok, tgt)
    p, _, l1 = step(p, state, tok, tgt)
    return float(l0), float(l1), jax.device_get(p)


def t_steps(cfg, axes, np_params, tokens, targets, opt):
    params = ttfm.params_from_jax(np_params, cfg)
    step = ttfm.make_train_step(cfg, tmesh(axes))
    state = opt(params)
    _, _, l0 = step(params, state, tokens, targets)
    _, _, l1 = step(params, state, tokens, targets)
    return float(l0), float(l1), params


def assert_params_close(tparams, jparams, rtol, atol):
    for name, want in jparams.items():
        if isinstance(want, dict):
            assert_params_close(tparams[name], want, rtol, atol)
            continue
        np.testing.assert_allclose(tparams[name].detach().numpy(),
                                   np.asarray(want), rtol=rtol, atol=atol,
                                   err_msg=name)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = cfgs()
    params = jax.device_get(jtfm.init_params(jax.random.PRNGKey(0), jcfg))
    tokens, targets = make_batch(0)
    return jcfg, tcfg, params, tokens, targets


@pytest.mark.parametrize("axes", FACTORIZATIONS, ids=_ids)
def test_sharded_loss_matches_jax_and_one_device(setup, axes):
    jcfg, tcfg, params, tokens, targets = setup
    if "pp" in axes:
        jcfg, tcfg = cfgs(microbatches=4)
    one = t_loss(tcfg, {}, params, tokens, targets)
    got = t_loss(tcfg, axes, params, tokens, targets)
    want = j_loss(jcfg, axes, params, tokens, targets)
    assert got == pytest.approx(want, rel=1e-4, abs=1e-5)
    assert got == pytest.approx(one, rel=1e-4, abs=1e-5)
    assert abs(one - np.log(tcfg.vocab)) < 1.0


@pytest.mark.parametrize("axes,micro", [(dict(dp=2, sp=2, tp=2), 1),
                                        (dict(dp=2, pp=2, tp=2), 2)],
                         ids=["dp2xsp2xtp2", "dp2xpp2xtp2"])
def test_train_step_parity(setup, axes, micro):
    _, _, params, tokens, targets = setup
    jcfg, tcfg = cfgs(microbatches=micro)
    ref0, ref1, _ = j_steps(jcfg, {}, params, tokens, targets,
                            optax.sgd(0.1))
    j0, j1, jp = j_steps(jcfg, axes, params, tokens, targets,
                         optax.sgd(0.1))
    t0, t1, tp = t_steps(tcfg, axes, params, tokens, targets,
                         optim.sgd(0.1))
    o0, o1, _ = t_steps(tcfg, {}, params, tokens, targets, optim.sgd(0.1))
    for got0, got1 in ((t0, t1), (o0, o1)):
        assert got0 == pytest.approx(ref0, rel=1e-4)
        assert got1 == pytest.approx(ref1, rel=1e-3, abs=1e-4)
    assert t0 == pytest.approx(j0, rel=1e-4)
    assert t1 == pytest.approx(j1, rel=1e-3, abs=1e-4)
    assert ref1 < ref0  # it actually learns
    # the gradients reached every global tensor once: the parameters
    # after two steps are JAX's (the gradients' tolerance, 2e-4)
    assert_params_close(tp, jp, rtol=2e-4, atol=2e-5)


class TestMoE:
    def test_moe_loss_parity_ep2(self):
        jcfg, tcfg = cfgs(n_experts=4, capacity_factor=4.0)
        params = jax.device_get(jtfm.init_params(jax.random.PRNGKey(1),
                                                 jcfg))
        tokens, targets = make_batch(1)
        ref = j_loss(jcfg, {}, params, tokens, targets)
        axes = dict(ep=2, tp=2)
        got = t_loss(tcfg, axes, params, tokens, targets)
        assert got == pytest.approx(ref, rel=1e-4, abs=1e-5)
        assert got == pytest.approx(j_loss(jcfg, axes, params, tokens,
                                           targets), rel=1e-4, abs=1e-5)
        assert got == pytest.approx(t_loss(tcfg, {}, params, tokens,
                                           targets), rel=1e-4, abs=1e-5)

    def test_moe_train_step_matches_jax(self):
        jcfg, tcfg = cfgs(n_experts=4, capacity_factor=4.0)
        params = jax.device_get(jtfm.init_params(jax.random.PRNGKey(2),
                                                 jcfg))
        tokens, targets = make_batch(2)
        axes = dict(dp=2, ep=2, tp=2)
        j0, j1, jp = j_steps(jcfg, axes, params, tokens, targets,
                             optax.sgd(0.1))
        t0, t1, tp = t_steps(tcfg, axes, params, tokens, targets,
                             optim.sgd(0.1))
        assert np.isfinite(t0) and t1 < t0
        assert t0 == pytest.approx(j0, rel=1e-4)
        assert t1 == pytest.approx(j1, rel=1e-3, abs=1e-4)
        assert_params_close(tp, jp, rtol=2e-4, atol=2e-5)


def test_flash_path_matches_ring_on_a_mesh(setup):
    """attn_impl="flash" on a mesh with sp = 1 (the kernel's plain twin
    on the CPU) against JAX's ring loss on the same mesh; with sp > 1 it
    is refused, as JAX refuses it."""
    _, _, params, tokens, targets = setup
    jcfg, _ = cfgs(microbatches=2)
    tcfg = ttfm.ModelConfig(**CFG, dtype=torch.float32, microbatches=2,
                            attn_impl="flash")
    axes = dict(dp=2, pp=2, tp=2)
    got = t_loss(tcfg, axes, params, tokens, targets)
    assert got == pytest.approx(j_loss(jcfg, axes, params, tokens, targets),
                                rel=1e-4, abs=1e-5)
    with pytest.raises(ValueError, match="single-shard"):
        t_loss(tcfg, dict(sp=2), params, tokens, targets)


def test_remat_train_step_matches_plain():
    jcfg, tcfg_a = cfgs(microbatches=2)
    tcfg_b = dataclasses.replace(tcfg_a, remat=True)
    params = jax.device_get(jtfm.init_params(jax.random.PRNGKey(3), jcfg))
    tokens, targets = make_batch(3)
    axes = dict(pp=2, tp=2)
    la = t_loss(tcfg_a, axes, params, tokens, targets)
    lb = t_loss(tcfg_b, axes, params, tokens, targets)
    assert la == pytest.approx(lb, rel=1e-5)
    a0, a1, _ = t_steps(tcfg_a, axes, params, tokens, targets,
                        optim.sgd(0.1))
    b0, b1, _ = t_steps(tcfg_b, axes, params, tokens, targets,
                        optim.sgd(0.1))
    assert np.isfinite(b0) and b1 < b0
    assert (b0, b1) == (a0, a1)  # remat recomputes the same arithmetic


MESHES = [dict(dp=2, pp=2, tp=2), dict(dp=2, sp=2, ep=2)]


@pytest.mark.parametrize("n_experts", [0, 4])
@pytest.mark.parametrize("axes", MESHES, ids=_ids)
def test_shard_params_equals_addressable_shards(axes, n_experts):
    jcfg, tcfg = cfgs(n_experts=n_experts, microbatches=1)
    params = jax.device_get(jtfm.init_params(jax.random.PRNGKey(4), jcfg))
    jm = jmesh(axes)
    jsharded = jtfm.shard_params(params, jcfg, jm)
    tm = tmesh(axes)
    tsharded = ttfm.shard_params(ttfm.params_from_jax(params, tcfg), tcfg,
                                 tm)
    coord_of = {d: dict(zip(jm.axis_names, idx))
                for idx, d in np.ndenumerate(jm.devices)}
    leaves = [("embed", "embed"), ("ln_f", "ln_f")] + [
        (f"layers/{k}", k) for k in params["layers"]]
    for path, key in leaves:
        jarr = jsharded["layers"][key] if path.startswith("layers/") \
            else jsharded[key]
        tarr = tsharded["layers"][key] if path.startswith("layers/") \
            else tsharded[key]
        for shard in jarr.addressable_shards:
            got = rank_view(tm, tarr, coord_of[shard.device])
            want = np.asarray(shard.data)
            assert tuple(got.shape) == want.shape, path
            np.testing.assert_array_equal(
                got.float().numpy() if got.dtype == torch.bfloat16
                else got.numpy(), want.astype(np.float32)
                if want.dtype.name == "bfloat16" else want, err_msg=path)


@pytest.mark.parametrize("n_experts", [0, 8])
def test_param_specs_match_jax(n_experts):
    jcfg, tcfg = cfgs(n_experts=n_experts)
    jspecs, tspecs = jtfm.param_specs(jcfg), ttfm.param_specs(tcfg)
    assert tuple(tspecs["embed"]) == tuple(jspecs["embed"])
    assert tuple(tspecs["ln_f"]) == tuple(jspecs["ln_f"])
    assert set(tspecs["layers"]) == set(jspecs["layers"])
    for k, spec in jspecs["layers"].items():
        assert tuple(tspecs["layers"][k]) == tuple(spec), k
    assert tuple(ttfm.batch_spec()) == tuple(jtfm.batch_spec())


def test_batch_sharding_views():
    mesh = tmesh(dict(dp=2, sp=2, ep=2))
    tokens = np.arange(8 * 16, dtype=np.int32).reshape(8, 16)
    st = ttfm.make_batch_sharding(mesh)(tokens)
    assert st.shape == (2, 1, 2, 2, 1, 2, 8)
    jm = jmesh(dict(dp=2, sp=2, ep=2))
    arr = jax.device_put(tokens, NamedSharding(jm, jtfm.batch_spec()))
    coord_of = {d: dict(zip(jm.axis_names, idx))
                for idx, d in np.ndenumerate(jm.devices)}
    for shard in arr.addressable_shards:
        np.testing.assert_array_equal(
            rank_view(mesh, st, coord_of[shard.device]).numpy(),
            np.asarray(shard.data))


def test_dryrun_multichip_covers_every_axis(capsys):
    ran = tentry.dryrun_multichip(8, device="cpu")
    assert [a for a, _ in ran] == [
        dict(dp=2, pp=2, sp=1, ep=1, tp=2),
        dict(dp=2, pp=1, sp=2, ep=2, tp=1)]
    assert all(np.isfinite(loss) for _, loss in ran)
    assert "ALL AXES > 1" in capsys.readouterr().out


@pytest.mark.parametrize("axes", MESHES, ids=_ids)
def test_dryrun_factorizations_match_jax(axes):
    """``__graft_entry__._dryrun_one``'s step (tiny config, capacity 4.0,
    adamw(1e-3), microbatches 2 at pp > 1) from JAX's weights on both
    packages: two steps' losses at test_models.py's bounds."""
    axes = dict(dict(dp=1, pp=1, sp=1, ep=1, tp=1), **axes)
    over = dict(n_experts=4 if axes["ep"] > 1 else 0, capacity_factor=4.0,
                microbatches=2 if axes["pp"] > 1 else 1)
    base = dict(vocab=64, d_model=32, n_layers=4, n_heads=4, head_dim=8,
                d_ff=64, max_seq=32, **over)
    jcfg = jtfm.ModelConfig(**base, dtype=jnp.float32)
    tcfg = ttfm.ModelConfig(**base, dtype=torch.float32)
    params = jax.device_get(jtfm.init_params(jax.random.PRNGKey(0), jcfg))
    b = 4 * axes["dp"] * axes["ep"] * jcfg.microbatches
    tokens, targets = tentry._batch(tcfg, b, 16 * axes["sp"])
    j0, j1, _ = j_steps(jcfg, axes, params, tokens, targets,
                        optax.adamw(1e-3))
    t0, t1, _ = t_steps(tcfg, axes, params, tokens, targets,
                        optim.adamw(1e-3))
    assert t0 == pytest.approx(j0, rel=1e-4)
    assert t1 == pytest.approx(j1, rel=1e-3, abs=1e-4)


class TestMixer:
    """The TpuMixer over dp and tp: ``tests/test_models.py::TestMixer``'s
    cases on both packages, from JAX's weights."""

    def _setup(self):
        from ompi_release_tpu.models import mixer as jmx
        from ompi_release_tpu_torch.models import mixer as tmx

        shape = dict(n_patches=16, d_model=32, d_token=16, d_channel=64,
                     n_layers=2, n_classes=8)
        jcfg = jmx.MixerConfig(**shape, dtype=jnp.float32)
        tcfg = tmx.MixerConfig(**shape, dtype=torch.float32)
        params = jax.device_get(jmx.init_params(jax.random.PRNGKey(0),
                                                jcfg))
        rng = np.random.RandomState(0)
        patches = rng.randn(8, 16, 32).astype(np.float32)
        labels = rng.randint(0, 8, size=(8,)).astype(np.int32)
        return jmx, tmx, jcfg, tcfg, params, patches, labels

    def _jloss(self, jmx, cfg, axes, params, patches, labels):
        mesh = jmesh(axes)
        sh = jmx.make_batch_sharding(mesh)
        return float(jmx.make_forward(cfg, mesh)(
            jmx.shard_params(params, cfg, mesh),
            jax.device_put(patches, sh), jax.device_put(labels, sh)))

    @pytest.mark.parametrize("axes", [dict(dp=2), dict(tp=2),
                                      dict(dp=2, tp=2), dict(dp=2, tp=4)],
                             ids=_ids)
    def test_sharded_loss_matches(self, axes):
        jmx, tmx, jcfg, tcfg, params, patches, labels = self._setup()
        tparams = tmx.params_from_jax(params, tcfg)
        ref = float(tmx.make_forward(tcfg, tmesh({}))(tparams, patches,
                                                      labels))
        assert abs(ref - np.log(tcfg.n_classes)) < 1.0
        got = float(tmx.make_forward(tcfg, tmesh(axes))(tparams, patches,
                                                        labels))
        assert got == pytest.approx(ref, rel=1e-4)
        assert got == pytest.approx(
            self._jloss(jmx, jcfg, axes, params, patches, labels), rel=1e-4)

    def test_train_step_learns_and_matches(self):
        jmx, tmx, jcfg, tcfg, params, patches, labels = self._setup()
        axes = dict(dp=2, tp=2)
        mesh = jmesh(axes)
        opt = optax.sgd(0.5)
        step = jmx.make_train_step(jcfg, mesh, opt)
        p = jmx.shard_params(params, jcfg, mesh)
        state = jax.jit(opt.init)(p)
        sh = jmx.make_batch_sharding(mesh)
        pt, lb = jax.device_put(patches, sh), jax.device_put(labels, sh)
        p, state, j0 = step(p, state, pt, lb)
        _, _, j1 = step(p, state, pt, lb)

        def run(axes_):
            tparams = tmx.params_from_jax(params, tcfg)
            tstep = tmx.make_train_step(tcfg, tmesh(axes_))
            st = optim.sgd(0.5)(tparams)
            _, _, l0 = tstep(tparams, st, patches, labels)
            _, _, l1 = tstep(tparams, st, patches, labels)
            return float(l0), float(l1)

        ref0, ref1 = run({})
        got0, got1 = run(axes)
        assert ref1 < ref0  # it learns
        assert got0 == pytest.approx(ref0, rel=1e-4)
        assert got1 == pytest.approx(ref1, rel=1e-3, abs=1e-4)
        assert got0 == pytest.approx(float(j0), rel=1e-4)
        assert got1 == pytest.approx(float(j1), rel=1e-3, abs=1e-4)

    def test_unsupported_axes_rejected(self):
        _, tmx, _, tcfg, _, _, _ = self._setup()
        with pytest.raises(ValueError):
            tmx.make_forward(tcfg, tmesh(dict(pp=2, tp=2)))

    def test_default_bf16_dtype_runs(self):
        """The default (bfloat16) config trains on a tp mesh without
        dtype drift: params keep their dtype across steps."""
        from ompi_release_tpu_torch.models import mixer as tmx

        cfg = tmx.MixerConfig(n_patches=8, d_model=16, d_token=8,
                              d_channel=32, n_layers=1, n_classes=4)
        params = tmx.init_params(cfg, torch.Generator().manual_seed(1))
        dtypes = {k: v.dtype for k, v in params["layers"].items()}
        step = tmx.make_train_step(cfg, tmesh(dict(tp=2)))
        rng = np.random.RandomState(1)
        patches = rng.randn(4, 8, 16).astype(np.float32)
        labels = rng.randint(0, 4, size=(4,)).astype(np.int32)
        _, _, loss = step(params, optim.sgd(0.1)(params), patches, labels)
        assert np.isfinite(float(loss))
        assert {k: v.dtype for k, v in params["layers"].items()} == dtypes

    def test_shard_params_equals_addressable_shards(self):
        jmx, tmx, jcfg, tcfg, params, _, _ = self._setup()
        axes = dict(dp=2, tp=2)
        jm = jmesh(axes)
        js = jmx.shard_params(params, jcfg, jm)
        tm = tmesh(axes)
        ts = tmx.shard_params(tmx.params_from_jax(params, tcfg), tcfg, tm)
        coord_of = {d: dict(zip(jm.axis_names, idx))
                    for idx, d in np.ndenumerate(jm.devices)}
        pairs = [(js["layers"][k], ts["layers"][k]) for k in js["layers"]]
        pairs += [(js["ln_f"], ts["ln_f"]), (js["head"], ts["head"])]
        for jarr, tarr in pairs:
            for shard in jarr.addressable_shards:
                np.testing.assert_array_equal(
                    rank_view(tm, tarr, coord_of[shard.device]).numpy(),
                    np.asarray(shard.data))


def test_parse_mesh():
    """``--mesh``'s argument: named axes, the rest 1; a bad one raises."""
    assert tentry.parse_mesh("dp=2,pp=2,tp=2") == dict(dp=2, pp=2, sp=1,
                                                       ep=1, tp=2)
    assert tentry.parse_mesh("") == dict(dp=1, pp=1, sp=1, ep=1, tp=1)
    for bad in ("xp=2", "dp", "dp=two"):
        with pytest.raises(ValueError, match="--mesh"):
            tentry.parse_mesh(bad)
