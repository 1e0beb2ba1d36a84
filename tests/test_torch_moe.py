"""The port's switch-MoE (``parallel/ep.py`` at ep = 1 and the MoE TpuLM),
held against the JAX package on the CPU.

The same inputs, made by numpy from a seed, go through the JAX function
and the port's:

- ``_one_hot_dispatch`` on the same f32 logits, with drops (capacity
  factor 0.5) and without (4.0): the dispatch tensor equal exactly, the
  combine tensor's zero pattern equal exactly and its values (the gate
  probabilities) within rtol 1e-6. XLA's and torch's f32 ``exp`` differ
  in the last bit on the CPU, so the softmax, and with it the gate, can
  differ by an ulp;
- ``moe_layer`` under ``jax.shard_map`` over a one-device mesh with an
  ``ep`` axis: out within rel 1e-5 (f32), aux within rel 1e-6;
- the MoE TpuLM (``tests/test_models.py``'s CFG with 4 experts, capacity
  factor 4.0 and 1.25), weights carried over by ``params_from_jax``: the
  forward loss within rel 1e-5 (f32, ring attention; bf16 rel 3e-2);
  gradients (``jax.grad`` against ``torch.autograd.grad``, every leaf,
  the router's included) within a relative L2 error of 2e-4; the losses
  of 3 ``adamw(1e-3)`` steps within rel 1e-4 of ``optax.adamw``'s. JAX's
  flash train step cannot run on the CPU, so the port's flash path (its
  plain twin) is held against the port's ring path (loss rel 1e-5,
  gradients 2e-4);
- ``params_from_jax`` for the MoE layout, and what it refuses.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

from ompi_release_tpu.models import transformer as jtfm
from ompi_release_tpu.parallel import ep as jep
from ompi_release_tpu.parallel.mesh_axes import (
    build_parallel_mesh as j_build_mesh,
)
from ompi_release_tpu_torch import optim
from ompi_release_tpu_torch.models import transformer as ttfm
from ompi_release_tpu_torch.optim import leaves
from ompi_release_tpu_torch.parallel import ep as tep
from ompi_release_tpu_torch.parallel.mesh_axes import (
    ParallelMesh, build_parallel_mesh,
)

CPU = torch.device("cpu")
#: tests/test_models.py's CFG with its expert count
CFG = dict(vocab=32, d_model=16, n_layers=2, n_heads=4, head_dim=4, d_ff=32,
           max_seq=16, n_experts=4)
CAPACITY = [4.0, 1.25]


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _batch(seed, b=8, s=16):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, CFG["vocab"], size=(b, s)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _cfgs(cap, jdt=jnp.float32, tdt=torch.float32, attn="ring"):
    return (jtfm.ModelConfig(**CFG, capacity_factor=cap, dtype=jdt,
                             attn_impl="ring"),
            ttfm.ModelConfig(**CFG, capacity_factor=cap, dtype=tdt,
                             attn_impl=attn))


def _np_params(jcfg, seed=1):
    return jax.device_get(jtfm.init_params(jax.random.PRNGKey(seed), jcfg))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# ---------------------------------------------------------------------------
# _one_hot_dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("capacity_factor,drops", [(0.5, True),
                                                   (4.0, False)])
def test_one_hot_dispatch_matches_jax(capacity_factor, drops, seed):
    t, e = 64, 4
    capacity = max(1, int(capacity_factor * t / e))
    logits = (np.random.RandomState(seed).randn(t, e) * 2).astype(np.float32)
    jd, jc = jep._one_hot_dispatch(jnp.asarray(logits), e, capacity)
    td, tc = tep._one_hot_dispatch(_t(logits), e, capacity)
    jd, jc = np.asarray(jd), np.asarray(jc)
    assert td.dtype == tc.dtype == torch.float32
    assert td.shape == tc.shape == (t, e, capacity)
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_array_equal(tc.numpy() != 0, jc != 0)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-6, atol=0)
    kept = int(jd.sum())
    assert (kept < t) == drops  # tokens over capacity were dropped
    # every slot holds at most one token, every token at most one slot
    assert jd.sum(axis=0).max() <= 1 and jd.sum(axis=(1, 2)).max() <= 1


def test_one_hot_dispatch_takes_the_first_maximum():
    logits = torch.tensor([[1.0, 1.0, 0.0], [0.0, 2.0, 2.0],
                           [1.0, 1.0, 0.0]])
    d, _ = tep._one_hot_dispatch(logits, 3, 4)
    assert d.nonzero().tolist() == [[0, 0, 0], [1, 1, 0], [2, 0, 1]]
    jd, _ = jep._one_hot_dispatch(jnp.asarray(logits.numpy()), 3, 4)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


# ---------------------------------------------------------------------------
# moe_layer at ep = 1
# ---------------------------------------------------------------------------

def _jax_expert(pe, t):
    w1, w2 = pe
    u = jnp.matmul(t, w1, preferred_element_type=jnp.float32)
    u = jax.nn.gelu(u).astype(t.dtype)
    return jnp.matmul(u, w2, preferred_element_type=jnp.float32).astype(
        t.dtype)


def _moe_inputs(seed, t=64, d=16, e=4, f=32):
    rng = np.random.RandomState(seed)
    return (rng.randn(t, d).astype(np.float32),
            (rng.randn(d, e) * 0.5).astype(np.float32),
            (rng.randn(e, d, f) / 4).astype(np.float32),
            (rng.randn(e, f, d) / 6).astype(np.float32))


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 4.0])
def test_moe_layer_matches_jax_at_ep1(capacity_factor):
    x, router, we1, we2 = _moe_inputs(int(capacity_factor * 4))
    mesh = j_build_mesh(devices=jax.devices()[:1])  # every axis 1, ep too

    def body(x, r, w1, w2):
        return jep.moe_layer(x, r, _jax_expert, (w1, w2), axis_name="ep",
                             capacity_factor=capacity_factor)

    jout, jaux = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(),) * 4, out_specs=(P(), P()),
        check_vma=False))(x, router, we1, we2)
    tout, taux = tep.moe_layer(_t(x), _t(router), ttfm._expert_fn,
                               (_t(we1), _t(we2)),
                               capacity_factor=capacity_factor)
    assert tout.shape == (64, 16) and taux.shape == ()
    assert _rel_l2(tout.numpy(), jout) <= 1e-5
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)


def test_moe_layer_drops_tokens_over_capacity_to_zero():
    x, router, we1, we2 = _moe_inputs(7)
    out, _ = tep.moe_layer(_t(x), _t(router), ttfm._expert_fn,
                           (_t(we1), _t(we2)), capacity_factor=0.5)
    logits = _t(x) @ _t(router)
    d, _ = tep._one_hot_dispatch(logits, 4, max(1, int(0.5 * 64 / 4)))
    dropped = d.sum(dim=(1, 2)) == 0
    assert 0 < int(dropped.sum()) < 64
    assert bool((out[dropped] == 0).all())
    assert bool((out[~dropped].abs().sum(dim=1) > 0).all())


def test_capacity_is_python_arithmetic():
    """``max(1, int(cf * T / E))`` as the reference computes it, with the
    float product's truncation: 1.25 * 10 / 4 = 3.125 -> 3 slots; 0.01 *
    10 / 4 -> 1 slot (never 0)."""
    for cf, want in ((1.25, 3), (0.01, 1), (4.0, 10)):
        x = torch.randn(10, 8)
        calls = []

        def expert(pe, t):
            calls.append(t.shape)
            return t

        tep.moe_layer(x, torch.randn(8, 4), expert, (torch.zeros(4, 1),),
                      capacity_factor=cf)
        assert calls == [(want, 8)] * 4


# ---------------------------------------------------------------------------
# the MoE TpuLM
# ---------------------------------------------------------------------------

def _jax_loss_and_grads(jcfg, np_params, tokens, targets):
    mesh = j_build_mesh(devices=jax.devices()[:1])
    fwd = jtfm.make_forward(jcfg, mesh)
    loss, grads = jax.value_and_grad(lambda p: fwd(p, tokens, targets))(
        jtfm.shard_params(np_params, jcfg, mesh))
    return float(loss), jax.device_get(grads)


def _named(tree):
    out = {n: t for n, t in tree.items() if n != "layers"}
    out.update({f"layers/{n}": t for n, t in tree["layers"].items()})
    return out


def _port_loss_and_grads(tcfg, params, tokens, targets):
    ts = leaves(params)
    for t in ts:
        t.requires_grad_(True)
    loss = ttfm.forward_loss(tcfg, params, torch.as_tensor(tokens),
                             torch.as_tensor(targets))
    grads = torch.autograd.grad(loss, ts)
    # leaves() walks the sorted keys, the nested ``layers`` in place
    named = [f"layers/{n}" for n in sorted(params["layers"])]
    named = [m for top in sorted(params)
             for m in (named if top == "layers" else [top])]
    return float(loss.detach()), dict(zip(named, grads))


@pytest.mark.parametrize("capacity_factor", CAPACITY)
def test_moe_forward_matches_jax_f32(capacity_factor):
    jcfg, tcfg = _cfgs(capacity_factor)
    np_params = _np_params(jcfg)
    tok, tgt = _batch(1)
    want, _ = _jax_loss_and_grads(jcfg, np_params, tok, tgt)
    mesh = build_parallel_mesh(devices=[CPU])
    got = ttfm.make_forward(tcfg, mesh)(
        ttfm.params_from_jax(np_params, tcfg), tok, tgt)
    assert float(got) == pytest.approx(want, rel=1e-5)
    assert abs(float(got) - np.log(CFG["vocab"])) < 1.0


def test_moe_forward_matches_jax_bf16():
    jcfg, tcfg = _cfgs(1.25, jnp.bfloat16, torch.bfloat16)
    np_params = _np_params(jcfg, seed=2)
    tok, tgt = _batch(2)
    want, _ = _jax_loss_and_grads(jcfg, np_params, tok, tgt)
    params = ttfm.params_from_jax(np_params, tcfg)
    assert params["layers"]["router"].dtype == torch.float32
    assert params["layers"]["we1"].dtype == torch.bfloat16
    got = ttfm.make_forward(tcfg, build_parallel_mesh(devices=[CPU]))(
        params, tok, tgt)
    assert float(got) == pytest.approx(want, rel=3e-2)


@pytest.mark.parametrize("capacity_factor", CAPACITY)
def test_moe_grads_match_jax(capacity_factor):
    jcfg, tcfg = _cfgs(capacity_factor)
    np_params = _np_params(jcfg)
    tok, tgt = _batch(1)
    want_loss, want = _jax_loss_and_grads(jcfg, np_params, tok, tgt)
    got_loss, got = _port_loss_and_grads(
        tcfg, ttfm.params_from_jax(np_params, tcfg), tok, tgt)
    assert got_loss == pytest.approx(want_loss, rel=1e-5)
    want = _named(want)
    assert set(got) == set(want)
    for name, g in got.items():
        assert np.abs(want[name]).max() > 0, name  # every leaf learns
        assert _rel_l2(g.numpy(), want[name]) <= 2e-4, name


@pytest.mark.parametrize("capacity_factor", CAPACITY)
def test_moe_adamw_losses_match_optax(capacity_factor):
    jcfg, tcfg = _cfgs(capacity_factor)
    np_params = _np_params(jcfg)
    tok, tgt = _batch(1)
    mesh = j_build_mesh(devices=jax.devices()[:1])
    opt = optax.adamw(1e-3)
    step = jtfm.make_train_step(jcfg, mesh, opt)
    p = jtfm.shard_params(np_params, jcfg, mesh)
    state = jax.jit(opt.init)(p)
    sh = jtfm.make_batch_sharding(mesh)
    jtok, jtgt = jax.device_put(tok, sh), jax.device_put(tgt, sh)
    want = []
    for _ in range(3):
        p, state, loss = step(p, state, jtok, jtgt)
        want.append(float(loss))
    params = ttfm.params_from_jax(np_params, tcfg)
    tstep = ttfm.make_train_step(tcfg, build_parallel_mesh(devices=[CPU]))
    tstate = optim.adamw(1e-3)(params)
    got = []
    for _ in range(3):
        params, tstate, loss = tstep(params, tstate, tok, tgt)
        got.append(float(loss))
    assert got == pytest.approx(want, rel=1e-4)
    assert got[2] < got[0]


@pytest.mark.parametrize("capacity_factor", CAPACITY)
def test_moe_flash_path_matches_ring(capacity_factor):
    jcfg, tcfg = _cfgs(capacity_factor)
    np_params = _np_params(jcfg, seed=3)
    tok, tgt = _batch(3)
    ring = _port_loss_and_grads(tcfg, ttfm.params_from_jax(np_params, tcfg),
                                tok, tgt)
    flash = _port_loss_and_grads(
        dataclasses.replace(tcfg, attn_impl="flash"),
        ttfm.params_from_jax(np_params, tcfg), tok, tgt)
    assert flash[0] == pytest.approx(ring[0], rel=1e-5)
    for name, g in flash[1].items():
        assert _rel_l2(g.numpy(), ring[1][name].numpy()) <= 2e-4, name


# ---------------------------------------------------------------------------
# parameters and configuration
# ---------------------------------------------------------------------------

def test_moe_params_from_jax_layout_and_refusals():
    jcfg, tcfg = _cfgs(1.25)
    np_params = _np_params(jcfg)
    params = ttfm.params_from_jax(np_params, tcfg)
    assert set(params["layers"]) == {"ln1", "wq", "wk", "wv", "wo", "ln2",
                                     "router", "we1", "we2"}
    for name, t in _named(params).items():
        np.testing.assert_array_equal(t.numpy(), _named(np_params)[name])
    layers = dict(np_params["layers"])
    missing = dict(np_params, layers={n: a for n, a in layers.items()
                                      if n != "router"})
    extra = dict(np_params, layers=dict(layers, w1=layers["we1"][:, 0]))
    shaped = dict(np_params, layers=dict(layers,
                                         we2=layers["we2"][:, :3]))
    for bad, match in ((missing, "keys"), (extra, "keys"),
                       (shaped, "the config gives")):
        with pytest.raises(ValueError, match=match):
            ttfm.params_from_jax(bad, tcfg)
    with pytest.raises(ValueError, match="keys"):  # the dense layout
        ttfm.params_from_jax(np_params, dataclasses.replace(tcfg,
                                                            n_experts=0))


def test_moe_init_params_shapes_dtypes_and_router_rounding():
    cfg = ttfm.ModelConfig(**dict(CFG, d_model=64, d_ff=128))  # bf16
    p = ttfm.init_params(cfg, torch.Generator().manual_seed(0))
    jshapes = jax.eval_shape(lambda: jtfm.init_params(
        jax.random.PRNGKey(0), jtfm.ModelConfig(**dict(CFG, d_model=64,
                                                       d_ff=128))))
    for name, t in p["layers"].items():
        j = jshapes["layers"][name]
        assert tuple(t.shape) == j.shape and str(t.dtype)[6:] == j.dtype.name
    router = p["layers"]["router"]
    assert router.dtype == torch.float32
    # drawn in f32, rounded to bf16, stored as f32 (transformer.py:106-108)
    assert torch.equal(router, router.to(torch.bfloat16).float())
    assert float(router.std()) == pytest.approx(0.02, rel=0.15)
    assert float(p["layers"]["we2"].float().std()) == pytest.approx(
        1 / np.sqrt(128), rel=0.1)


def test_moe_validate_checks_experts_against_ep():
    cfg = ttfm.ModelConfig(**dict(CFG, n_experts=3))
    mesh = ParallelMesh(shape=dict(dp=1, pp=1, sp=1, ep=2, tp=1),
                        device=CPU)
    with pytest.raises(ValueError, match="n_experts must divide by ep"):
        cfg.validate(mesh)
    jmesh = j_build_mesh(devices=jax.devices()[:2], ep=2)
    with pytest.raises(ValueError, match="n_experts must divide by ep"):
        jtfm.ModelConfig(**dict(CFG, n_experts=3)).validate(jmesh)
    ttfm.ModelConfig(**CFG).validate(mesh)  # 4 experts over ep 2


def test_moe_tpulm_trains_on_the_cpu():
    cfg = ttfm.ModelConfig(**CFG, dtype=torch.float32, capacity_factor=1.25)
    model = ttfm.TpuLM(cfg, device="cpu", seed=0)
    tok, tgt = _batch(4)
    losses = [float(model.train_step(tok, tgt)) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[2] < losses[0]
    assert model.layers["router"].grad is not None
