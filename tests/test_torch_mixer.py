"""The port's TpuMixer (``models/mixer.py``), held against the JAX
package's ``models/mixer.py`` on the CPU.

The same inputs, made by numpy from a seed, go through both, with the
weights carried over by ``params_from_jax``:

- ``tests/test_models.py``'s TestMixer config in f32: the loss within
  rel 1e-5 of ``make_forward`` on a one-device mesh; two ``sgd(0.5)``
  steps within that file's tolerances (rel 1e-4, then rel 1e-3 / abs
  1e-4), and the loss falls;
- the bf16 config of ``test_default_bf16_dtype_runs``: parameters keep
  their dtypes across an ``sgd(0.1)`` step, and the loss is within rel
  1e-2 of JAX's (torch's GELU rounds once, XLA's on the CPU may round
  between its steps);
- ``_layernorm`` against the JAX function (f32 rtol 1e-6);
- pp/sp/ep != 1 rejected by both, ``params_from_jax``'s refusals, and
  the ``TpuMixer`` module on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ompi_release_tpu.models import mixer as jmx
from ompi_release_tpu.parallel.mesh_axes import (
    build_parallel_mesh as j_build_mesh,
)
from ompi_release_tpu_torch import models, optim
from ompi_release_tpu_torch.models import mixer as tmx
from ompi_release_tpu_torch.parallel.mesh_axes import (
    ParallelMesh, build_parallel_mesh,
)
from ompi_release_tpu_torch.utils.errors import ErrorCode, MPIError

CPU = torch.device("cpu")
#: tests/test_models.py's TestMixer config
KW = dict(n_patches=16, d_model=32, d_token=16, d_channel=64, n_layers=2,
          n_classes=8)
#: its bf16 config (test_default_bf16_dtype_runs)
KW_BF16 = dict(n_patches=8, d_model=16, d_token=8, d_channel=32, n_layers=1,
               n_classes=4)


def _setup(kw=KW, jdt=jnp.float32, tdt=torch.float32, seed=0, b=8):
    jcfg = jmx.MixerConfig(**kw, dtype=jdt)
    tcfg = tmx.MixerConfig(**kw, dtype=tdt)
    np_params = jax.device_get(jmx.init_params(jax.random.PRNGKey(seed),
                                               jcfg))
    rng = np.random.RandomState(seed)
    patches = rng.randn(b, kw["n_patches"], kw["d_model"]).astype(np.float32)
    labels = rng.randint(0, kw["n_classes"], size=(b,)).astype(np.int32)
    return jcfg, tcfg, np_params, patches, labels


def _jax_steps(jcfg, np_params, patches, labels, lr, n):
    mesh = j_build_mesh(devices=jax.devices()[:1])
    opt = optax.sgd(lr)
    step = jmx.make_train_step(jcfg, mesh, opt)
    p = jmx.shard_params(np_params, jcfg, mesh)
    state = jax.jit(opt.init)(p)
    sh = jmx.make_batch_sharding(mesh)
    pt, lb = jax.device_put(patches, sh), jax.device_put(labels, sh)
    losses = []
    for _ in range(n):
        p, state, loss = step(p, state, pt, lb)
        losses.append(float(loss))
    return losses, jax.device_get(p)


def _port_steps(tcfg, np_params, patches, labels, lr, n):
    params = tmx.params_from_jax(np_params, tcfg)
    step = tmx.make_train_step(tcfg, build_parallel_mesh(devices=[CPU]))
    state = optim.sgd(lr)(params)
    losses = []
    for _ in range(n):
        params, state, loss = step(params, state, patches, labels)
        assert loss.shape == () and not loss.requires_grad
        losses.append(float(loss))
    return losses, params


def test_mixer_loss_matches_jax_f32():
    jcfg, tcfg, np_params, patches, labels = _setup()
    mesh = j_build_mesh(devices=jax.devices()[:1])
    sh = jmx.make_batch_sharding(mesh)
    want = float(jmx.make_forward(jcfg, mesh)(
        jmx.shard_params(np_params, jcfg, mesh), jax.device_put(patches, sh),
        jax.device_put(labels, sh)))
    got = tmx.make_forward(tcfg, build_parallel_mesh(devices=[CPU]))(
        tmx.params_from_jax(np_params, tcfg), patches, labels)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == pytest.approx(want, rel=1e-5)
    assert abs(float(got) - np.log(KW["n_classes"])) < 1.0


def test_mixer_two_sgd_steps_match_jax():
    jcfg, tcfg, np_params, patches, labels = _setup()
    (ref0, ref1), _ = _jax_steps(jcfg, np_params, patches, labels, 0.5, 2)
    (got0, got1), _ = _port_steps(tcfg, np_params, patches, labels, 0.5, 2)
    assert ref1 < ref0 and got1 < got0  # it learns
    assert got0 == pytest.approx(ref0, rel=1e-4)
    assert got1 == pytest.approx(ref1, rel=1e-3, abs=1e-4)


def test_mixer_bf16_keeps_dtypes_and_matches_jax():
    jcfg, tcfg, np_params, patches, labels = _setup(
        KW_BF16, jnp.bfloat16, torch.bfloat16, seed=1, b=4)
    (want,), jp = _jax_steps(jcfg, np_params, patches, labels, 0.1, 1)
    (got,), params = _port_steps(tcfg, np_params, patches, labels, 0.1, 1)
    assert np.isfinite(got)
    assert got == pytest.approx(want, rel=1e-2)
    shapes = tmx.param_shapes(tcfg)
    for name, (_, dtype) in shapes["layers"].items():
        assert params["layers"][name].dtype == dtype  # no promotion
        assert str(dtype)[6:] == jp["layers"][name].dtype.name
    assert params["head"].dtype == torch.bfloat16
    assert params["ln_f"].dtype == torch.float32


def test_layernorm_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(4, 6, 32).astype(np.float32) * 3 + 1
    g = rng.rand(32).astype(np.float32) + 0.5
    want = np.asarray(jmx._layernorm(jnp.asarray(x), jnp.asarray(g)))
    got = tmx._layernorm(torch.from_numpy(x), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert tmx._layernorm(xb, torch.from_numpy(g)).dtype == torch.bfloat16


@pytest.mark.parametrize("axis", ["pp", "sp", "ep"])
def test_mixer_rejects_pp_sp_ep(axis):
    cfg = tmx.MixerConfig(**KW)
    shape = {**dict(dp=1, pp=1, sp=1, ep=1, tp=1), axis: 2}
    with pytest.raises(ValueError, match=f"'{axis}' must be 1"):
        tmx.make_forward(cfg, ParallelMesh(shape=shape, device=CPU))
    with pytest.raises(ValueError, match=f"'{axis}' must be 1"):
        tmx.make_train_step(cfg, ParallelMesh(shape=shape, device=CPU))
    jmesh = j_build_mesh(devices=jax.devices()[:2], **{axis: 2})
    with pytest.raises(ValueError, match=f"'{axis}' must be 1"):
        jmx.make_forward(jmx.MixerConfig(**KW), jmesh)


def test_mixer_params_from_jax_refusals():
    _, tcfg, np_params, _, _ = _setup()
    params = tmx.params_from_jax(np_params, tcfg)
    np.testing.assert_array_equal(params["layers"]["wt1"].numpy(),
                                  np_params["layers"]["wt1"])
    layers = dict(np_params["layers"])
    missing = dict(np_params, layers={n: a for n, a in layers.items()
                                      if n != "wc2"})
    extra = dict(np_params, bias=np.zeros(3, np.float32))
    shaped = dict(np_params, head=np_params["head"][:, :3])
    for bad, match in ((missing, "keys"), (extra, "keys"),
                       (shaped, "the config gives")):
        with pytest.raises(ValueError, match=match):
            tmx.params_from_jax(bad, tcfg)
    with pytest.raises(ValueError, match="the config gives"):
        tmx.params_from_jax(np_params, dataclasses.replace(
            tcfg, dtype=torch.bfloat16))


def test_mixer_init_params_shapes_dtypes_and_scales():
    cfg = tmx.MixerConfig()  # the full-width default, bf16
    p = tmx.init_params(cfg, torch.Generator().manual_seed(0))
    jshapes = jax.eval_shape(lambda: jmx.init_params(
        jax.random.PRNGKey(0), jmx.MixerConfig()))
    for name, t in list(p["layers"].items()) + [("ln_f", p["ln_f"]),
                                                 ("head", p["head"])]:
        j = jshapes["layers"][name] if name in p["layers"] else jshapes[name]
        assert tuple(t.shape) == j.shape and str(t.dtype)[6:] == j.dtype.name
    assert float(p["layers"]["wc2"].float().std()) == pytest.approx(
        1 / np.sqrt(cfg.d_channel), rel=0.1)
    assert bool((p["layers"]["ln2"] == 1).all())


def test_tpumixer_module_on_the_cpu():
    assert models.TpuMixer is tmx.TpuMixer
    cfg = tmx.MixerConfig(**KW, dtype=torch.float32)
    model = tmx.TpuMixer(cfg, device="cpu", seed=0, lr=0.5)
    _, _, _, patches, labels = _setup()
    before = float(model(patches, labels))
    losses = [float(model.train_step(patches, labels)) for _ in range(3)]
    assert losses[0] == pytest.approx(before, rel=1e-6)
    assert losses[2] < losses[0]
    assert model.opt_state.defaults["lr"] == 0.5
    if not torch.cuda.is_available():
        with pytest.raises(MPIError) as e:
            tmx.TpuMixer(cfg)
        assert e.value.code == ErrorCode.ERR_NOT_AVAILABLE
