"""The port's flagship eval forward, held against the JAX package.

The same inputs, made by numpy from a seed, go through the JAX function
and its port counterpart:

- the flash module's plain twin against ``_flash_forward`` run in
  interpret mode under ``jax.vmap`` (out and lse; f32 2e-5, bf16 3e-2:
  ``tests/test_pallas.py``'s tolerances);
- the single-rank helpers (tp / cp / pp at axis size 1, rmsnorm, rope)
  against the JAX functions, directly or under a one-device
  ``shard_map``: f32 rtol 1e-6, with atol 1e-6 for entries near zero,
  where the two libraries' summation orders differ by a few ulps of the
  summands rather than of the sum;
- the whole forward (``make_forward``) with weights carried over by
  ``params_from_jax`` against JAX ``make_forward`` on a one-device mesh:
  f32 rel 1e-5 for ``attn_impl`` "flash" (interpret) and "ring", bf16
  rel 3e-2;
- ``entry(device="cpu")`` against ``__graft_entry__.entry()``;
- the cases that raise.
"""

import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ompi_release_tpu.models import transformer as jtfm
from ompi_release_tpu.ops.pallas_attention import _flash_forward
from ompi_release_tpu.parallel import cp as jcp, pp as jpp, tp as jtp
from ompi_release_tpu.parallel.mesh_axes import (
    build_parallel_mesh as j_build_mesh,
)
from ompi_release_tpu_torch.models import transformer as ttfm
from ompi_release_tpu_torch.ops import cuda_op
from ompi_release_tpu_torch.ops import flash_attention as tfa
from ompi_release_tpu_torch.parallel import cp as tcp, pp as tpp, tp as ttp
from ompi_release_tpu_torch.parallel.mesh_axes import build_parallel_mesh
from ompi_release_tpu_torch.utils.errors import ErrorCode, MPIError

CPU = torch.device("cpu")
#: tests/test_models.py's CFG
CFG = dict(vocab=32, d_model=16, n_layers=2, n_heads=4, head_dim=4, d_ff=32,
           max_seq=16)
CFG4 = dict(vocab=64, d_model=32, n_layers=4, n_heads=4, head_dim=8, d_ff=64,
            max_seq=32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _close(got, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _one_device(fn, n_in):
    """fn under shard_map on a one-device mesh with all five axes bound,
    every operand replicated."""
    mesh = j_build_mesh(devices=jax.devices()[:1])
    return jax.shard_map(fn, mesh=mesh, in_specs=(P(),) * n_in,
                         out_specs=P(), check_vma=False)


# ---------------------------------------------------------------------------
# flash module: plain twin vs the Pallas kernel (interpret)
# ---------------------------------------------------------------------------

FLASH_CASES = [  # (S, D, block): every S, D and block at least twice
    (1, 4, 16), (1, 16, 128), (16, 8, 32), (16, 4, 16), (100, 16, 32),
    (100, 8, 128), (129, 4, 128), (129, 8, 16), (129, 16, 32),
]


def _flash_pair(s, d, block, causal, jdt, tdt, seed):
    rng = np.random.RandomState(seed)
    qkv = [rng.randn(2, 3, s, d).astype(np.float32) for _ in range(3)]
    fn = jax.vmap(partial(_flash_forward, causal=causal, block_q=block,
                          block_k=block, interpret=True))
    jo, jl = fn(*[jnp.asarray(x, jdt) for x in qkv])
    tq, tk, tv = (_t(x, tdt) for x in qkv)
    po, pl = tfa._plain_flash_forward(
        *(x.reshape(6, s, d) for x in (tq, tk, tv)), causal, block, block)
    wo, wl = tfa.flash_forward(tq, tk, tv, causal)  # the wrapper, (2, 3, S, D)
    return (np.asarray(jo, np.float32), np.asarray(jl)), \
        (po.view(2, 3, s, d), pl.view(2, 3, s)), (wo, wl)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,d,block", FLASH_CASES)
def test_plain_flash_matches_pallas_f32(s, d, block, causal):
    (jo, jl), (po, pl), (wo, wl) = _flash_pair(
        s, d, block, causal, jnp.float32, torch.float32, seed=s * 31 + d)
    for o, lse in ((po, pl), (wo, wl)):
        assert o.dtype == torch.float32 and lse.dtype == torch.float32
        _close(o, jo, rtol=2e-5, atol=2e-5)
        _close(lse, jl, rtol=2e-5, atol=2e-5)
        assert torch.isfinite(lse).all()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,d,block", [(16, 8, 16), (100, 16, 32),
                                       (129, 8, 128), (129, 16, 32)])
def test_plain_flash_matches_pallas_bf16(s, d, block, causal):
    (jo, jl), (po, pl), (wo, wl) = _flash_pair(
        s, d, block, causal, jnp.bfloat16, torch.bfloat16, seed=s + d)
    for o, lse in ((po, pl), (wo, wl)):
        assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
        _close(o.float(), jo, rtol=3e-2, atol=3e-2)
        _close(lse, jl, rtol=3e-2, atol=3e-2)


def test_flash_attention_cpu_takes_the_plain_twin():
    """A CPU tensor never reaches the kernel: no launch is counted, and
    ``flash_attention`` is ``flash_forward``'s out."""
    rng = np.random.RandomState(7)
    q, k, v = (_t(rng.randn(2, 40, 8)) for _ in range(3))
    before = cuda_op.LAUNCHES["flash_fwd"]
    out = tfa.flash_attention(q, k, v, causal=True)
    assert torch.equal(out, tfa.flash_forward(q, k, v, True)[0])
    assert torch.equal(out, tfa._plain_flash_forward(q, k, v, True)[0])
    assert cuda_op.LAUNCHES["flash_fwd"] == before
    assert tfa.flash_forward(q[:, :0], k[:, :0], v[:, :0], True)[0].shape \
        == (2, 0, 8)


# ---------------------------------------------------------------------------
# single-rank helpers
# ---------------------------------------------------------------------------

def test_rmsnorm_and_rope_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 16, 4, 8).astype(np.float32)
    g = rng.rand(8).astype(np.float32) + 0.5
    _close(ttfm._rmsnorm(_t(x), _t(g)), jtfm._rmsnorm(jnp.asarray(x), g))
    pos = np.arange(16)
    _close(ttfm._rope(_t(x), torch.arange(16), 10000.0),
           jtfm._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))


def test_tp_layers_match_jax_at_tp1():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 16).astype(np.float32)
    # weights at the model's 1/sqrt(fan-in) scale: outputs of order 1
    w = (rng.randn(16, 24) / 4).astype(np.float32)
    w2 = (rng.randn(24, 16) / np.sqrt(24)).astype(np.float32)
    _close(ttp.column_parallel(_t(x), _t(w)),
           _one_device(partial(jtp.column_parallel, axis_name="tp"), 2)(x, w))
    _close(ttp.row_parallel(_t(x @ w), _t(w2)),
           _one_device(partial(jtp.row_parallel, axis_name="tp"), 2)(
               x @ w, w2))
    table = rng.randn(32, 16).astype(np.float32)
    ids = rng.randint(0, 32, size=(2, 8)).astype(np.int32)
    ids[0, 0], ids[1, 3] = -1, 32  # out of range: zero rows
    want = _one_device(partial(jtp.vocab_parallel_embedding, axis_name="tp"),
                       2)(ids, table)
    got = ttp.vocab_parallel_embedding(torch.from_numpy(ids), _t(table))
    _close(got, want, rtol=0, atol=0)
    assert not got[0, 0].any() and not got[1, 3].any()
    tgt = rng.randint(0, 32, size=(2, 8)).astype(np.int32)
    tgt[1, 1] = 40  # out of range: zero target logit
    _close(ttp.vocab_parallel_xent(_t(x), _t(table), torch.from_numpy(tgt)),
           _one_device(partial(jtp.vocab_parallel_xent, axis_name="tp"),
                       3)(x, table, tgt))


@pytest.mark.parametrize("causal", [False, True])
def test_cp_attention_matches_jax_at_sp1(causal):
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(4, 24, 8).astype(np.float32) for _ in range(3))
    tq, tk, tv = (_t(a) for a in (q, k, v))
    _close(tcp.ring_attention(tq, tk, tv, causal=causal),
           _one_device(partial(jcp.ring_attention, axis_name="sp",
                               causal=causal), 3)(q, k, v))
    _close(tcp.local_flash_attention(tq, tk, tv, causal=causal),
           jcp.local_flash_attention(q, k, v, causal=causal))
    mask = np.tril(np.ones((24, 24), bool)) if causal else None
    for got, want in zip(
            tcp._block_attn(tq, tk, tv, None if mask is None
                            else torch.from_numpy(mask)),
            jcp._block_attn(q, k, v, mask)):
        _close(got, want)


def test_cp_bf16_rounds_p_to_v_dtype():
    """``p.astype(v.dtype)`` (cp.py:38) in bf16, and the batched layout
    (mb, H, S, D) the model hands ring attention."""
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(2, 3, 20, 8).astype(np.float32) for _ in range(3))
    want = jax.vmap(_one_device(partial(jcp.ring_attention, axis_name="sp",
                                        causal=True), 3))(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    got = tcp.ring_attention(*(_t(a, torch.bfloat16) for a in (q, k, v)),
                             causal=True)
    assert got.dtype == torch.bfloat16
    _close(got.float(), want, rtol=1e-2, atol=1e-2)


def test_one_stage_pipeline_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(3, 2, 4, 8).astype(np.float32)  # (M, mb, S, D)
    w = rng.randn(8, 8).astype(np.float32)

    def jstage(p, h):
        return jnp.tanh(h @ p)

    def tstage(p, h):
        return torch.tanh(h @ p)

    want = _one_device(partial(jpp.pipeline, jstage, axis_name="pp"), 2)(
        w, x)
    _close(tpp.pipeline(tstage, _t(w), _t(x)), want)


# ---------------------------------------------------------------------------
# the whole forward
# ---------------------------------------------------------------------------

def _jax_loss(cfg, np_params, tokens, targets):
    mesh = j_build_mesh(devices=jax.devices()[:1])
    fwd = jtfm.make_forward(cfg, mesh)
    sh = jtfm.make_batch_sharding(mesh)
    return float(fwd(jtfm.shard_params(np_params, cfg, mesh),
                     jax.device_put(tokens, sh), jax.device_put(targets, sh)))


def _setup(cfg_kw, jdt, tdt, seed, b=8, s=16):
    jcfg = jtfm.ModelConfig(**cfg_kw, dtype=jdt)
    tcfg = ttfm.ModelConfig(**cfg_kw, dtype=tdt)
    np_params = jax.device_get(jtfm.init_params(jax.random.PRNGKey(seed),
                                                jcfg))
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, jcfg.vocab, size=(b, s)).astype(np.int32)
    return jcfg, tcfg, np_params, tokens, np.roll(tokens, -1, axis=1)


@pytest.mark.parametrize("attn", ["flash", "ring", "auto"])
@pytest.mark.parametrize("cfg_kw", [CFG, CFG4], ids=["cfg", "cfg4"])
def test_forward_matches_jax_f32(cfg_kw, attn):
    jcfg, tcfg, np_params, tok, tgt = _setup(cfg_kw, jnp.float32,
                                             torch.float32, seed=0)
    jcfg = dataclasses.replace(jcfg, attn_impl=attn)
    tcfg = dataclasses.replace(tcfg, attn_impl=attn)
    want = _jax_loss(jcfg, np_params, tok, tgt)
    mesh = build_parallel_mesh(devices=[CPU])
    got = ttfm.make_forward(tcfg, mesh)(
        ttfm.params_from_jax(np_params, tcfg), tok, tgt)
    assert got.shape == () and got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-5)
    assert abs(float(got) - np.log(tcfg.vocab)) < 1.0


@pytest.mark.parametrize("attn", ["flash", "ring"])
def test_forward_matches_jax_bf16_with_microbatches(attn):
    kw = dict(CFG4, microbatches=2, attn_impl=attn)
    jcfg, tcfg, np_params, tok, tgt = _setup(kw, jnp.bfloat16,
                                             torch.bfloat16, seed=1)
    want = _jax_loss(jcfg, np_params, tok, tgt)
    params = ttfm.params_from_jax(np_params, tcfg)
    assert params["layers"]["wq"].dtype == torch.bfloat16
    assert params["ln_f"].dtype == torch.float32
    got = ttfm.make_forward(tcfg, build_parallel_mesh(devices=[CPU]))(
        params, tok, tgt)
    assert float(got) == pytest.approx(want, rel=3e-2)


def test_auto_takes_ring_on_the_cpu_and_flash_when_forced(monkeypatch):
    calls = {"flash": 0, "ring": 0}
    real_flash, real_ring = ttfm.flash_attention, tcp.ring_attention

    def flash(*a, **kw):
        calls["flash"] += 1
        return real_flash(*a, **kw)

    def ring(*a, **kw):
        calls["ring"] += 1
        return real_ring(*a, **kw)

    monkeypatch.setattr(ttfm, "flash_attention", flash)
    monkeypatch.setattr(tcp, "ring_attention", ring)
    tcfg = ttfm.ModelConfig(**CFG4, dtype=torch.float32)
    model = ttfm.TpuLM(tcfg, device="cpu", seed=3)
    tok = np.random.RandomState(3).randint(0, 64, size=(2, 8))
    loss_auto = model(tok, np.roll(tok, -1, 1))
    assert calls == {"flash": 0, "ring": 4}
    forced = ttfm.make_forward(dataclasses.replace(tcfg, attn_impl="flash"),
                               model.mesh)
    loss_flash = forced(model.params(), tok, np.roll(tok, -1, 1))
    assert calls == {"flash": 4, "ring": 4}
    assert float(loss_flash) == pytest.approx(float(loss_auto), rel=1e-5)


def test_init_params_shapes_dtypes_and_scales():
    cfg = ttfm.ModelConfig(**CFG4)  # bf16 weights, f32 norms
    p = ttfm.init_params(cfg, torch.Generator().manual_seed(0))
    jshapes = jax.eval_shape(lambda: jtfm.init_params(
        jax.random.PRNGKey(0), jtfm.ModelConfig(**CFG4)))
    for name, t in list(p.items()) + list(p["layers"].items()):
        if name == "layers":
            continue
        j = jshapes[name] if name in jshapes else jshapes["layers"][name]
        assert tuple(t.shape) == j.shape and str(t.dtype)[6:] == j.dtype.name
    assert float(p["embed"].float().std()) == pytest.approx(0.02, rel=0.1)
    assert float(p["layers"]["w2"].float().std()) == pytest.approx(
        1 / np.sqrt(CFG4["d_ff"]), rel=0.1)
    assert bool((p["layers"]["ln1"] == 1).all())


def test_entry_matches_graft_entry_with_carried_weights():
    import __graft_entry__ as graft
    from ompi_release_tpu_torch.entry import entry

    jfn, (jparams, jtok, jtgt) = graft.entry()
    want = float(jfn(jparams, jtok, jtgt))
    fn, (params, tok, tgt) = entry(device="cpu")
    assert np.array_equal(tok.numpy(), np.asarray(jtok))
    assert np.array_equal(tgt.numpy(), np.asarray(jtgt))
    from ompi_release_tpu_torch.entry import _tiny_cfg

    carried = ttfm.params_from_jax(jax.device_get(jparams), _tiny_cfg())
    assert float(fn(carried, tok, tgt)) == pytest.approx(want, rel=1e-5)
    assert np.isfinite(float(fn(params, tok, tgt)))


# ---------------------------------------------------------------------------
# what raises
# ---------------------------------------------------------------------------

def test_not_ported_cases_raise():
    with pytest.raises(MPIError, match="slice 3 item 15") as e:
        ttfm.ModelConfig(n_experts=4)
    assert e.value.code == ErrorCode.ERR_NOT_AVAILABLE
    for axes in (dict(tp=2), dict(dp=2), dict(sp=2, pp=2)):
        with pytest.raises(MPIError, match="multi-card slice"):
            build_parallel_mesh(devices=[CPU], **axes)
    with pytest.raises(ValueError, match="devices"):
        build_parallel_mesh(devices=[CPU, CPU])
    with pytest.raises(ValueError, match="attn_impl"):
        ttfm.ModelConfig(attn_impl="dense")


def test_flash_wrapper_raises_on_what_the_kernel_does_not_take():
    q = torch.randn(2, 16, 8, requires_grad=True)
    # under grad the backward exists: the plain backward twin on the CPU
    out = tfa.flash_attention(q, q.detach(), q.detach())
    (dq,) = torch.autograd.grad(out, q, torch.ones_like(out))
    o, lse = tfa._plain_flash_forward(q.detach(), q.detach(), q.detach(),
                                      False)
    want = tfa._plain_flash_backward(q.detach(), q.detach(), q.detach(), o,
                                     lse, torch.ones_like(o), False)[0]
    assert torch.equal(dq, want)
    with torch.no_grad():  # grad disabled: the forward runs
        assert tfa.flash_attention(q, q, q).shape == q.shape
    big = torch.randn(2, 16, 129)
    with pytest.raises(MPIError, match="head dim 129"):
        tfa.flash_forward(big, big, big, True)
    i = torch.zeros(2, 16, 8, dtype=torch.int32)
    with pytest.raises(MPIError, match="float32/bfloat16"):
        tfa.flash_forward(i, i, i, True)
    x = torch.randn(2, 16, 8)
    with pytest.raises(MPIError, match="differ"):
        tfa.flash_forward(x, x[:, :8], x, True)
    with pytest.raises(MPIError, match="differ"):
        tfa.flash_forward(x, x.to(torch.bfloat16), x, True)
    with pytest.raises(MPIError, match="at least"):
        tfa.flash_forward(x[0], x[0], x[0], True)


def test_params_from_jax_rejects_a_mismatched_tree():
    jcfg, tcfg, np_params, _, _ = _setup(CFG, jnp.float32, torch.float32, 0)
    with pytest.raises(ValueError, match="the config gives"):
        ttfm.params_from_jax(np_params, dataclasses.replace(tcfg, d_ff=64))
    with pytest.raises(ValueError, match="the config gives"):
        ttfm.params_from_jax(np_params, dataclasses.replace(
            tcfg, dtype=torch.bfloat16))
    bad = dict(np_params, extra=np.zeros(1))
    with pytest.raises(ValueError, match="keys"):
        ttfm.params_from_jax(bad, tcfg)


def test_tpulm_without_cuda_raises_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: TpuLM() would succeed")
    cfg = ttfm.ModelConfig(**CFG, dtype=torch.float32)
    with pytest.raises(MPIError) as e:
        ttfm.TpuLM(cfg)
    assert e.value.code == ErrorCode.ERR_NOT_AVAILABLE
    assert "device='cpu'" in str(e.value)
    with pytest.raises(MPIError) as e:
        build_parallel_mesh()
    assert e.value.code == ErrorCode.ERR_NOT_AVAILABLE
    assert ttfm.TpuLM(cfg, device="cpu").device == CPU
