"""The port's train step, held against the JAX package's.

JAX's ``make_train_step`` runs here only with ``attn_impl="ring"``: with
``"flash"`` on the CPU its shard_map is built with ``check_vma=False``
(``transformer.py:306-315``), and the pp psum then refuses to transpose.
So the whole-step reference is JAX's ring step, and the port is held to
it with both of its attention paths: ``"ring"`` (autograd through ring
attention) and ``"flash"`` (the autograd Function over the plain flash
twins, ``tests/test_torch_flash_grad.py`` holds that backward against
the Pallas one).

Setup: ``tests/test_models.py``'s tiny config, weights carried over
with ``params_from_jax``, a (8, 16) batch from numpy. Tolerances:
- loss before and after one ``sgd(0.1)`` step: f32 rel 1e-5;
- gradients, read off an ``sgd(1.0)`` step as ``p0 - p1``: rtol/atol
  2e-4 (the JAX suite's grad tolerance);
- ``adamw(1e-3)``: the losses of 3 steps within rel 1e-4 (AdamW's
  first-step parameters are not compared elementwise: where a gradient
  is near 0, ``m / (sqrt(v) + 1e-8)`` amplifies rounding);
- bf16: the losses of two ``sgd(0.1)`` steps within rel 3e-2, and of 3
  ``adamw(1e-3)`` steps within rel 1e-4 (the full-width step's
  optimizer in its working type);
- ``remat=True`` equals ``remat=False`` bitwise (loss and gradients);
- the tp repair: ``vocab_parallel_xent``'s gradient against ``jax.grad``
  of the JAX function (f32 rtol/atol 1e-6).
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

from ompi_release_tpu.models import transformer as jtfm
from ompi_release_tpu.parallel import tp as jtp
from ompi_release_tpu.parallel.mesh_axes import (
    build_parallel_mesh as j_build_mesh,
)
from ompi_release_tpu_torch import optim
from ompi_release_tpu_torch.models import transformer as ttfm
from ompi_release_tpu_torch.optim import leaves
from ompi_release_tpu_torch.parallel import tp as ttp
from ompi_release_tpu_torch.parallel.mesh_axes import build_parallel_mesh

CPU = torch.device("cpu")
#: tests/test_models.py's CFG
CFG = dict(vocab=32, d_model=16, n_layers=2, n_heads=4, head_dim=4, d_ff=32,
           max_seq=16)
#: optax transform and its port counterpart, by name
OPTS = {"sgd0.1": (lambda: optax.sgd(0.1), lambda: optim.sgd(0.1)),
        "sgd1": (lambda: optax.sgd(1.0), lambda: optim.sgd(1.0)),
        "adamw": (lambda: optax.adamw(1e-3), lambda: optim.adamw(1e-3))}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
_JAX_RUNS = {}


def _batch(seed=0, b=8, s=16):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, CFG["vocab"], size=(b, s)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _jax_run(dtype, opt, n_steps):
    """JAX's ring train step from PRNGKey(0): (initial params as numpy,
    final params as numpy, the pre-update loss of each step). Cached:
    each (dtype, optimizer) compiles once."""
    key = (dtype, opt, n_steps)
    if key not in _JAX_RUNS:
        jcfg = jtfm.ModelConfig(**CFG, dtype=DTYPES[dtype][0],
                                attn_impl="ring")
        params = jax.device_get(jtfm.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
        mesh = j_build_mesh(devices=jax.devices()[:1])
        jopt = OPTS[opt][0]()
        step = jtfm.make_train_step(jcfg, mesh, jopt)
        p = jtfm.shard_params(params, jcfg, mesh)
        state = jax.jit(jopt.init)(p)
        sh = jtfm.make_batch_sharding(mesh)
        tok, tgt = (jax.device_put(a, sh) for a in _batch())
        losses = []
        for _ in range(n_steps):
            p, state, loss = step(p, state, tok, tgt)
            losses.append(float(loss))
        _JAX_RUNS[key] = (params, jax.device_get(p), losses)
    return _JAX_RUNS[key]


def _port_run(np_params, dtype, opt, n_steps, attn, **over):
    tcfg = ttfm.ModelConfig(**CFG, dtype=DTYPES[dtype][1], attn_impl=attn,
                            **over)
    params = ttfm.params_from_jax(np_params, tcfg)
    step = ttfm.make_train_step(tcfg, build_parallel_mesh(devices=[CPU]))
    state = OPTS[opt][1]()(params)
    tok, tgt = _batch()
    losses = []
    for _ in range(n_steps):
        params, state, loss = step(params, state, tok, tgt)
        assert loss.shape == () and not loss.requires_grad
        losses.append(float(loss))
    return params, losses


def _named(params):
    out = {n: t for n, t in params.items() if n != "layers"}
    out.update({f"layers/{n}": t for n, t in params["layers"].items()})
    return out


@pytest.mark.parametrize("attn", ["ring", "flash"])
def test_train_step_losses_match_jax_sgd(attn):
    np_params, _, want = _jax_run("f32", "sgd0.1", 2)
    _, got = _port_run(np_params, "f32", "sgd0.1", 2, attn)
    assert got == pytest.approx(want, rel=1e-5)
    assert got[1] < got[0]


@pytest.mark.parametrize("attn", ["ring", "flash"])
def test_train_step_grads_match_jax(attn):
    """``p0 - p1`` of one ``sgd(1.0)`` step is the gradient on both
    sides; every leaf within rtol/atol 2e-4."""
    np_params, np_after, _ = _jax_run("f32", "sgd1", 1)
    params, _ = _port_run(np_params, "f32", "sgd1", 1, attn)
    before = _named(ttfm.params_from_jax(np_params, ttfm.ModelConfig(
        **CFG, dtype=torch.float32)))
    after = _named(params)
    want_after = _named(np_after)
    assert set(after) == set(want_after)
    for name, p1 in after.items():
        p0 = before[name].numpy()
        grad = p0 - p1.detach().numpy()
        want = p0 - np.asarray(want_after[name], np.float32)
        np.testing.assert_allclose(grad, want, rtol=2e-4, atol=2e-4,
                                   err_msg=name)
        assert np.abs(want).max() > 0, name  # every leaf gets a gradient


@pytest.mark.parametrize("attn", ["ring", "flash"])
def test_train_step_adamw_losses_match_jax(attn):
    np_params, _, want = _jax_run("f32", "adamw", 3)
    _, got = _port_run(np_params, "f32", "adamw", 3, attn)
    assert got == pytest.approx(want, rel=1e-4)
    assert got[2] < got[1] < got[0]


@pytest.mark.parametrize("attn", ["ring", "flash"])
def test_train_step_bf16_adamw_losses_match_jax(attn):
    """The full-width step's optimizer in its working type: bf16 weights,
    3 ``adamw(1e-3)`` steps, losses within rel 1e-4 of optax's."""
    np_params, _, want = _jax_run("bf16", "adamw", 3)
    params, got = _port_run(np_params, "bf16", "adamw", 3, attn)
    assert params["layers"]["wq"].dtype == torch.bfloat16
    assert got == pytest.approx(want, rel=1e-4)
    assert got[2] < got[1] < got[0]


@pytest.mark.parametrize("attn", ["ring", "flash"])
def test_train_step_bf16_matches_jax(attn):
    np_params, _, want = _jax_run("bf16", "sgd0.1", 2)
    params, got = _port_run(np_params, "bf16", "sgd0.1", 2, attn)
    assert params["layers"]["wq"].dtype == torch.bfloat16
    assert params["ln_f"].dtype == torch.float32
    assert got == pytest.approx(want, rel=3e-2)


@pytest.mark.parametrize("attn", ["ring", "flash"])
def test_remat_is_bitwise_equal(attn):
    np_params, _, _ = _jax_run("f32", "sgd1", 1)
    runs = [_port_run(np_params, "f32", "sgd1", 2, attn, remat=remat,
                      microbatches=2) for remat in (False, True)]
    (p_off, l_off), (p_on, l_on) = runs
    assert l_off == l_on
    for name, t in _named(p_off).items():
        assert torch.equal(t, _named(p_on)[name]), name


def test_vocab_parallel_xent_grad_matches_jax():
    """The max shift carries no gradient on either side (JAX's
    ``_pmax_nograd``); the gradient in h and in the table against
    ``jax.grad`` under a one-device shard_map. Rows 0 and 1 of the table
    are equal, so logits tie, and one row's max is a tie."""
    rng = np.random.RandomState(6)
    h = rng.randn(2, 8, 16).astype(np.float32)
    table = rng.randn(32, 16).astype(np.float32)
    table[1] = table[0]
    h[0, 0] = table[0] * 3  # logits 0 and 1 tie at the row's max
    tgt = rng.randint(0, 32, size=(2, 8)).astype(np.int32)
    tgt[1, 1] = 40  # out of range: zero target logit
    w = rng.randn(2, 8).astype(np.float32)
    mesh = j_build_mesh(devices=jax.devices()[:1])
    jfn = jax.shard_map(partial(jtp.vocab_parallel_xent, axis_name="tp"),
                        mesh=mesh, in_specs=(P(),) * 3, out_specs=P(),
                        check_vma=False)
    want = jax.grad(lambda h, t: (jfn(h, t, tgt) * w).sum(),
                    argnums=(0, 1))(h, table)
    th, tt = (torch.from_numpy(a).requires_grad_() for a in (h, table))
    nll = ttp.vocab_parallel_xent(th, tt, torch.from_numpy(tgt))
    got = torch.autograd.grad((nll * torch.from_numpy(w)).sum(), (th, tt))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    logits = torch.from_numpy(h) @ torch.from_numpy(table).t()
    assert logits[0, 0, 0] == logits[0, 0, 1] == logits[0, 0].max()


def test_optimizers_take_optax_defaults():
    p = {"w": torch.ones(3), "layers": {"b": torch.zeros(2)}}
    state = optim.adamw(1e-3)(p)
    assert isinstance(state, torch.optim.AdamW)
    group = state.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (1e-3, (0.9, 0.999), 1e-8, 1e-4)
    assert [t for t in group["params"]] == leaves(p) == [p["layers"]["b"],
                                                         p["w"]]
    assert all(t.requires_grad for t in leaves(p))
    sgd = optim.sgd(0.5)({"w": torch.ones(2)})
    assert isinstance(sgd, torch.optim.SGD)
    assert sgd.param_groups[0]["lr"] == 0.5
    assert sgd.param_groups[0]["momentum"] == 0


def test_train_entry_matches_dryrun_one_at_axes_1():
    """``train_entry(device="cpu")`` is ``_dryrun_one``'s step at every
    axis 1: with JAX's weights carried over, 3 ``adamw(1e-3)`` steps give
    JAX's losses (rel 1e-4); from its own seed the loss falls."""
    import __graft_entry__ as graft
    from ompi_release_tpu_torch.entry import _tiny_cfg, train_entry

    step, (params, state, tok, tgt) = train_entry(device="cpu")
    assert tok.device == CPU and tuple(tok.shape) == (4, 16)
    own = []
    for _ in range(4):
        params, state, loss = step(params, state, tok, tgt)
        own.append(float(loss))
    assert np.isfinite(own).all() and own[3] < own[2] < own[1] < own[0]

    jcfg = graft._tiny_cfg(capacity_factor=4.0)
    mesh = j_build_mesh(devices=jax.devices()[:1])
    np_params = jax.device_get(jtfm.init_params(jax.random.PRNGKey(0), jcfg))
    jopt = optax.adamw(1e-3)
    jstep = jtfm.make_train_step(jcfg, mesh, jopt)
    p = jtfm.shard_params(np_params, jcfg, mesh)
    jstate = jax.jit(jopt.init)(p)
    sh = jtfm.make_batch_sharding(mesh)
    jtok, jtgt = (jax.device_put(a, sh) for a in graft._batch(jcfg, 4, 16))
    assert np.array_equal(np.asarray(jtok), tok.numpy())
    want = []
    for _ in range(3):
        p, jstate, loss = jstep(p, jstate, jtok, jtgt)
        want.append(float(loss))

    carried = ttfm.params_from_jax(np_params, _tiny_cfg())
    cstate = optim.adamw(1e-3)(carried)
    got = []
    for _ in range(3):
        carried, cstate, loss = step(carried, cstate, tok, tgt)
        got.append(float(loss))
    assert got == pytest.approx(want, rel=1e-4)


def test_tpulm_train_step_updates_in_place_and_eval_is_unchanged():
    """``TpuLM.train_step``: frozen parameters become trainable at the
    first step and are updated in place; the eval forward still runs
    under inference_mode and sees the new weights."""
    cfg = ttfm.ModelConfig(**CFG, dtype=torch.float32, attn_impl="flash")
    model = ttfm.TpuLM(cfg, device="cpu", seed=2)
    assert not any(p.requires_grad for p in model.parameters())
    tok, tgt = _batch(seed=2)
    wq = model.params()["layers"]["wq"]
    before = wq.detach().clone()
    eval0 = float(model(tok, tgt))
    loss0 = model.train_step(tok, tgt)
    assert float(loss0) == pytest.approx(eval0, rel=1e-6)
    assert all(p.requires_grad for p in model.parameters())
    assert isinstance(model.opt_state, torch.optim.AdamW)
    assert model.opt_state.defaults["lr"] == 1e-3
    assert model.params()["layers"]["wq"] is wq and not torch.equal(wq,
                                                                   before)
    loss1 = model.train_step(tok, tgt)
    assert float(loss1) < float(loss0)
    assert float(model(tok, tgt)) < float(loss1)
