"""TpuLM — the flagship decoder-only transformer: the eval forward and
the train step, on one device or sharded over a 5-axis mesh of virtual
ranks of one device.

Counterpart of ``ompi_release_tpu/models/transformer.py``: the same
configuration, parameter layout, layers, loss and train step. The path
is tokens -> embedding -> n_layers blocks (RMSNorm, RoPE, q/k/v,
causal attention, output projection, tanh-GELU MLP) -> final RMSNorm ->
tied-embedding cross-entropy -> mean loss.

On a mesh (``parallel.build_parallel_mesh``, any dp, pp, sp, ep, tp)
every strategy of the reference is load-bearing: the batch splits over
(dp, ep) and the sequence over sp; the trunk's layers split over pp and
run the GPipe ring (``parallel.pp``); attention is exact ring attention
over sp with RoPE on global positions (``parallel.cp``) when sp > 1;
heads, FFN and vocab split over tp (``parallel.tp``); the MoE's experts
split over ep (``parallel.ep``). The per-rank code runs over the
stacked layout of ``parallel/mesh_axes.py``: every rank's slice in one
tensor, each op one launch for all ranks. The parameters stay global
tensors; ``shard_params`` hands the per-rank code their views, so the
gradient of a replicated parameter is the sum over its replicas and the
optimizer updates each tensor once. A one-device mesh runs the
unsharded forward.

Attention (``attn_impl``, the JAX meaning): ``"flash"`` is
``ops.flash_attention`` (the CUDA kernel on the card, its plain twin on
the CPU), ``"ring"`` is ``parallel.cp.ring_attention``, and ``"auto"``
is the kernel on a CUDA device when sp = 1 and ring elsewhere, as JAX
picks the Pallas kernel on a TPU and ring elsewhere.

Parameters are a dict of tensors shaped as the JAX pytree, per-layer
weights stacked on a leading ``n_layers`` axis; ``params_from_jax``
carries a JAX pytree (as numpy arrays) over. The gradient is autograd's
through the same forward, with ``flash_attention``'s backward the flash
backward kernels (their plain twins on the CPU). ``n_experts > 0`` puts
the switch-MoE FFN (``parallel.ep.moe_layer``) in every layer in place
of the dense one; its auxiliary load-balancing loss is computed and
discarded, as the reference does.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention
from ..optim import adamw
from ..parallel import axes, cp, ep as ep_mod, pp as pp_mod, tp as tp_mod
from ..parallel import tree as tree_mod
from ..parallel.mesh_axes import P, ParallelMesh, build_parallel_mesh


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab: int = 32000
    d_model: int = 512
    n_layers: int = 8
    n_heads: int = 8
    head_dim: int = 64
    d_ff: int = 2048
    max_seq: int = 2048
    n_experts: int = 0  # 0 = dense FFN; >0 = switch-MoE every layer
    capacity_factor: float = 1.25
    microbatches: int = 1  # microbatch count of the pp schedule
    remat: bool = False  # checkpoint the trunk: recompute in the backward
    dtype: Any = torch.bfloat16
    rope_base: float = 10000.0
    # "auto" = the CUDA flash kernel on a card, ring attention elsewhere;
    # "ring" / "flash" force one path (flash runs its plain twin on CPU)
    attn_impl: str = "auto"

    def __post_init__(self):
        if self.attn_impl not in ("auto", "flash", "ring"):
            raise ValueError(f"attn_impl {self.attn_impl!r}: one of "
                             "'auto', 'flash', 'ring'")

    def validate(self, mesh: ParallelMesh) -> None:
        ax = dict(mesh.shape)
        if self.n_layers % ax.get("pp", 1):
            raise ValueError("n_layers must divide by pp")
        if self.n_heads % ax.get("tp", 1):
            raise ValueError("n_heads must divide by tp")
        if self.vocab % ax.get("tp", 1):
            raise ValueError("vocab must divide by tp")
        if self.d_ff % ax.get("tp", 1):
            raise ValueError("d_ff must divide by tp")
        if self.n_experts and self.n_experts % ax.get("ep", 1):
            raise ValueError("n_experts must divide by ep")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def param_shapes(cfg: ModelConfig) -> Dict:
    """``{name: (shape, dtype)}`` of the parameter dict, ``layers``
    nested: the JAX ``init_params`` pytree's structure."""
    d, l, dt, e = cfg.d_model, cfg.n_layers, cfg.dtype, cfg.n_experts
    hdim = cfg.n_heads * cfg.head_dim
    f32 = torch.float32
    layers = {
        "ln1": ((l, d), f32),
        "wq": ((l, d, hdim), dt),
        "wk": ((l, d, hdim), dt),
        "wv": ((l, d, hdim), dt),
        "wo": ((l, hdim, d), dt),
        "ln2": ((l, d), f32),
    }
    if e:
        layers.update(router=((l, d, e), f32),
                      we1=((l, e, d, cfg.d_ff), dt),
                      we2=((l, e, cfg.d_ff, d), dt))
    else:
        layers.update(w1=((l, d, cfg.d_ff), dt), w2=((l, cfg.d_ff, d), dt))
    return {"embed": ((cfg.vocab, d), dt), "ln_f": ((d,), f32),
            "layers": layers}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Random parameters with the shapes, dtypes and scales of the JAX
    ``init_params`` (``transformer.py:82-114``): N(0, 1) in f32 times
    0.02 for the embedding and 1/sqrt(fan-in) for the weights, cast to
    ``cfg.dtype``; norms are f32 ones. The MoE router is drawn at scale
    0.02, cast to ``cfg.dtype`` and stored as f32 (``transformer.py:
    106-108``: its values are rounded to ``cfg.dtype``). Drawn on the
    CPU from ``generator`` (the numbers differ from JAX's), then
    moved."""
    def make(name, shape, dtype):
        if name.startswith("ln"):
            return torch.ones(shape, dtype=dtype)
        scale = 0.02 if name in ("embed", "router") \
            else 1.0 / math.sqrt(shape[-2])
        x = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (x * scale).to(cfg.dtype).to(dtype)

    shapes = param_shapes(cfg)
    params = {n: make(n, *sd) for n, sd in shapes.items() if n != "layers"}
    params["layers"] = {n: make(n, *sd)
                        for n, sd in shapes["layers"].items()}
    return to_device(params, device)


def to_device(params: Dict, device) -> Dict:
    """The (nested) parameter dict with every tensor moved to ``device``
    (``params`` itself when ``device`` is None)."""
    if device is None:
        return params
    return {n: to_device(t, device) if isinstance(t, dict) else t.to(device)
            for n, t in params.items()}


def _from_numpy(a) -> torch.Tensor:
    a = np.array(a)  # a writable copy: device_get's arrays are read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes: reinterpret the 16 bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def tree_from_jax(np_params: Dict, shapes: Dict) -> Dict:
    """A JAX parameter pytree (numpy arrays) as a dict of tensors, value
    for value, checked against ``shapes`` (a ``param_shapes`` dict).
    Raises if a leaf is missing, extra, or of another shape or dtype."""
    def convert(tree, spec, where):
        if set(tree) != set(spec):
            raise ValueError(f"params_from_jax: {where or 'top'} keys "
                             f"{sorted(tree)} != {sorted(spec)}")
        out = {}
        for name, want in spec.items():
            if isinstance(want, dict):
                out[name] = convert(tree[name], want, f"{where}{name}/")
                continue
            t = _from_numpy(tree[name])
            if (tuple(t.shape), t.dtype) != (want[0], want[1]):
                raise ValueError(
                    f"params_from_jax: {where}{name} is {tuple(t.shape)} "
                    f"{t.dtype}, the config gives {want[0]} {want[1]}")
            out[name] = t
        return out

    return convert(np_params, shapes, "")


def params_from_jax(np_params: Dict, cfg: ModelConfig, device=None) -> Dict:
    """The JAX pytree (``init_params`` output as numpy arrays, e.g.
    ``jax.device_get(params)``) as the port's parameter dict, value for
    value. Raises if a leaf is missing, extra, or of another shape or
    dtype than ``cfg`` gives it."""
    return to_device(tree_from_jax(np_params, param_shapes(cfg)), device)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _rmsnorm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + 1e-6)
    return (x32 * r * axes.align(g, x.dim() - axes.lead(x))).to(x.dtype)


def _rope(x: torch.Tensor, pos: torch.Tensor, base: float) -> torch.Tensor:
    """x: (..., mb, S, H, Dh); pos: (S,) positions, or (ranks..., 1, S)
    global positions inside a mesh. Non-interleaved halves, angles in
    f32."""
    half = x.shape[-1] // 2
    freq = torch.pow(
        torch.tensor(base, dtype=torch.float32),
        -torch.arange(half, dtype=torch.float32) / half).to(x.device)
    ang = pos[..., None].float() * freq  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _use_flash(cfg: ModelConfig, device: torch.device) -> bool:
    """The JAX rule: "flash", or "auto" on the accelerator (here a CUDA
    device, there a TPU), when the sequence is local to the rank (sp =
    1); ring attention over sp otherwise."""
    sp_n = axes.axis_size_or_1("sp")
    if cfg.attn_impl == "flash" and sp_n > 1:
        raise ValueError(
            "attn_impl='flash' is single-shard attention; with sp>1 "
            "use 'ring' (or 'auto', which picks ring for sharded seq)")
    return sp_n == 1 and (cfg.attn_impl == "flash" or (
        cfg.attn_impl == "auto" and device.type == "cuda"))


def _layer(cfg: ModelConfig, lp: Dict, x: torch.Tensor) -> torch.Tensor:
    """One transformer block. x: (mb, S_loc, D) per rank (inside a mesh
    with the rank dims in front)."""
    n = axes.lead(x)
    mb, s = x.shape[n], x.shape[n + 1]
    # global positions: the sp rank's block of the sequence
    pos = axes.axis_index("sp", 2) * s + torch.arange(s, device=x.device)
    h = _rmsnorm(x, lp["ln1"])
    hl = lp["wq"].shape[-1] // cfg.head_dim

    def qkv(w):
        y = tp_mod.column_parallel(h, w)
        return y.reshape(y.shape[:-1] + (hl, cfg.head_dim))

    q = _rope(qkv(lp["wq"]), pos, cfg.rope_base)
    k = _rope(qkv(lp["wk"]), pos, cfg.rope_base)
    v = qkv(lp["wv"])
    # (mb, H, S, Dh): the JAX vmap over mb written out as a batch dim
    q, k, v = (t.transpose(-3, -2).contiguous() for t in (q, k, v))
    if _use_flash(cfg, x.device):
        attn = flash_attention(q, k, v, True)
    else:
        attn = cp.ring_attention(q, k, v, causal=True)
    attn = attn.transpose(-3, -2)
    attn = attn.reshape(attn.shape[:-2] + (hl * cfg.head_dim,))
    x = x + tp_mod.row_parallel(attn, lp["wo"])

    h2 = _rmsnorm(x, lp["ln2"])
    if cfg.n_experts:
        out, _aux = ep_mod.moe_layer(
            h2.reshape(h2.shape[:n] + (mb * s, cfg.d_model)), lp["router"],
            _expert_fn, (lp["we1"], lp["we2"]),
            capacity_factor=cfg.capacity_factor)
        return x + out.reshape(out.shape[:n] + (mb, s, cfg.d_model))
    u = tp_mod.column_parallel(h2, lp["w1"])
    # jax.nn.gelu's default is the tanh approximation
    u = F.gelu(u.float(), approximate="tanh").to(x.dtype)
    return x + tp_mod.row_parallel(u, lp["w2"])


def _expert_fn(pe, t: torch.Tensor) -> torch.Tensor:
    """The experts' FFN (``transformer.py:224-231``): (C, D) tokens of one
    expert, or inside a mesh (..., E_local, C, D) of them all. Unlike the
    dense branch, the first product is not rounded before the GELU: it
    is the f32 product of the bf16 values (exact products, f32 sums),
    GELU'd in f32 and then rounded; the second rounds once."""
    w1, w2 = pe
    u = torch.matmul(t.float(), w1.float())
    u = F.gelu(u, approximate="tanh").to(t.dtype)
    return torch.matmul(u, w2).to(t.dtype)


def _trunk(cfg: ModelConfig, stage_layers: Dict,
           x: torch.Tensor) -> torch.Tensor:
    """The stage's layers in order (the JAX ``lax.scan`` over the
    leading axis of the stacked weights; inside a mesh the pp rank's
    slice of them)."""
    n = axes.lead(x)
    for i in range(stage_layers["ln1"].shape[n]):
        x = _layer(cfg, {k: t.select(n, i) for k, t in stage_layers.items()},
                   x)
    return x


# ---------------------------------------------------------------------------
# the sharded model: per-rank code over the stacked layout of a mesh
# ---------------------------------------------------------------------------

#: regex partition rules, first match wins (``parallel.tree.
#: match_partition_rules``): which mesh axis owns which tensor dim, keyed
#: by parameter path name (``transformer.py:116-131``)
PARTITION_RULES = (
    (r"^embed$", P("tp", None)),
    (r"^ln_f$", P()),
    (r"layers/ln[12]$", P("pp", None)),
    (r"layers/w[qkv]$", P("pp", None, "tp")),
    (r"layers/wo$", P("pp", "tp", None)),
    (r"layers/router$", P("pp", None, None)),
    (r"layers/we[12]$", P("pp", "ep", None, None)),
    (r"layers/w1$", P("pp", None, "tp")),
    (r"layers/w2$", P("pp", "tp", None)),
)


def _skeleton(shapes: Dict) -> Dict:
    """A ``param_shapes`` dict as meta tensors (shapes, no storage)."""
    return {n: _skeleton(v) if isinstance(v, dict)
            else torch.empty(v[0], dtype=v[1], device="meta")
            for n, v in shapes.items()}


def param_specs(cfg: ModelConfig) -> Dict:
    """``PartitionSpec``s matching the parameter dict, from
    :data:`PARTITION_RULES` (an unmatched leaf raises)."""
    return tree_mod.match_partition_rules(PARTITION_RULES,
                                          _skeleton(param_shapes(cfg)))


def batch_spec():
    return P(("dp", "ep"), "sp")


def _map2(f, a: Dict, b: Dict) -> Dict:
    return {n: _map2(f, v, b[n]) if isinstance(v, dict) else f(v, b[n])
            for n, v in a.items()}


def shard_params(params: Dict, cfg: ModelConfig, mesh: ParallelMesh) -> Dict:
    """Each global parameter as its stacked per-rank views on ``mesh``
    under :func:`param_specs` (``mesh.stack``: sharded dims split to the
    axes' rank dims, replicated axes size-1 rank dims). Views, no copies:
    the gradient of a view reaches the global tensor, summed over the
    ranks that share it (the replicas' allreduce)."""
    return _map2(mesh.stack, params, param_specs(cfg))


def make_batch_sharding(mesh: ParallelMesh):
    """``fn(tokens) -> stacked views``: a global (B, S) batch under
    :func:`batch_spec`, moved to the mesh's device first."""
    return lambda a: mesh.stack(torch.as_tensor(a, device=mesh.device),
                                batch_spec())


def forward_loss(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                 targets: torch.Tensor) -> torch.Tensor:
    """The scalar mean cross-entropy (``transformer.py:249-291``) on one
    device, tokens/targets (B, S) int; or per rank inside a mesh, params
    stacked by :func:`shard_params` and tokens/targets (b_loc, S_loc) per
    rank. The pipeline's outputs are real on the last pp stage only
    (zeros elsewhere), so the final norm and the f32 LM head run on that
    stage's slice alone: the psum over pp of the reference's masked loss
    adds exact zeros. Inside a mesh the loss is invariant over every
    axis."""
    n = axes.lead(tokens)
    b_loc, s_loc = tokens.shape[n:]
    m = cfg.microbatches
    if b_loc % m:
        raise ValueError(f"batch {b_loc} per rank does not split into {m} "
                         "microbatches")
    emb = tp_mod.vocab_parallel_embedding(tokens,
                                          params["embed"]).to(cfg.dtype)
    x_mb = emb.reshape(emb.shape[:n] + (m, b_loc // m, s_loc, cfg.d_model))
    y = pp_mod.pipeline(partial(_trunk, cfg), params["layers"], x_mb,
                        remat=cfg.remat)
    pp_n = axes.axis_size_or_1("pp")
    if pp_n > 1:
        y = y.narrow(axes.current_mesh().axis_dim("pp"), pp_n - 1, 1)
    h = _rmsnorm(y.reshape(y.shape[:n] + (b_loc, s_loc, cfg.d_model)),
                 params["ln_f"])
    nll = tp_mod.vocab_parallel_xent(h.float(), params["embed"].float(),
                                     targets)
    total = b_loc * s_loc * math.prod(axes.axis_size_or_1(a)
                                      for a in ("dp", "ep", "sp"))
    local = nll.sum(dim=(-2, -1)) / total
    return axes.psum(local, ("dp", "sp", "ep"))


def sharded_loss(cfg: ModelConfig, mesh: ParallelMesh, params: Dict,
                 tokens: torch.Tensor, targets: torch.Tensor
                 ) -> torch.Tensor:
    """The scalar loss of global params and a global (B, S) batch over
    ``mesh``'s ranks (the reference's shard_map'd loss with out_specs
    ``P()``)."""
    batch = make_batch_sharding(mesh)
    with mesh:
        loss = forward_loss(cfg, shard_params(params, cfg, mesh),
                            batch(tokens), batch(targets))
    return loss.reshape(())


def _loss_on(cfg: ModelConfig, mesh: ParallelMesh):
    if mesh.size == 1:
        return partial(forward_loss, cfg)
    return partial(sharded_loss, cfg, mesh)


def eval_fn(loss_fn, device: torch.device):
    """``fn(params, *batch) -> scalar loss``: ``loss_fn(params, *batch)``
    on ``device`` under ``torch.inference_mode()``, the batch's arrays
    (numpy or tensors) moved there first."""
    def fn(params: Dict, *batch) -> torch.Tensor:
        with torch.inference_mode():
            return loss_fn(params, *(torch.as_tensor(a, device=device)
                                     for a in batch))

    return fn


def train_step_fn(loss_fn, device: torch.device):
    """``step(params, opt_state, *batch) -> (params, opt_state, loss)``:
    the loss on ``device``, its gradient by ``loss.backward()`` and one
    ``opt_state.step()``; ``loss`` is the detached pre-update loss."""
    def step(params: Dict, opt_state, *batch):
        opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(params, *(torch.as_tensor(a, device=device)
                                 for a in batch))
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return step


def make_forward(cfg: ModelConfig, mesh: ParallelMesh):
    """The loss-evaluation forward (the flagship inference/eval path) on
    ``mesh``'s device: ``fn(params, tokens, targets) -> scalar loss``.
    Tokens and targets may be numpy arrays or tensors; the forward runs
    under ``torch.inference_mode()``."""
    cfg.validate(mesh)
    return eval_fn(_loss_on(cfg, mesh), mesh.device)


def make_train_step(cfg: ModelConfig, mesh: ParallelMesh):
    """The full train step on ``mesh``'s device (``transformer.py:
    325-344``): ``step(params, opt_state, tokens, targets) -> (params,
    opt_state, loss)`` with ``opt_state = optimizer(params)``, a
    ``torch.optim.Optimizer`` from ``optim.sgd`` / ``optim.adamw`` (the
    optax counterparts). It takes the loss, its gradient by
    ``loss.backward()`` and one ``opt_state.step()``. Two differences
    from JAX: the update rule rides in the state, so the factory takes
    no optimizer; and the port updates the parameter tensors (and the
    state) in place, returning the same objects where JAX returns new
    pytrees. ``loss`` is the detached pre-update loss."""
    cfg.validate(mesh)
    return train_step_fn(_loss_on(cfg, mesh), mesh.device)


class OneDeviceModel(nn.Module):
    """A model of the family on one device: its parameters (frozen until
    the first :meth:`train_step`), the eval forward and the train step
    its module's ``make_forward`` / ``make_train_step`` build.
    ``device`` defaults to ``cuda:0``; without CUDA it raises
    ``ERR_NOT_AVAILABLE`` unless the caller asks for ``device="cpu"``,
    as ``init()`` does. ``params`` default to the module's
    ``init_params`` from ``seed``; the first train step builds
    ``optimizer(params)``. ``mesh`` (``parallel.build_parallel_mesh``)
    shards the model over virtual ranks of its device: the parameters
    stay global tensors, each step runs over their stacked views."""

    def __init__(self, cfg, params: Optional[Dict], device, seed: int,
                 optimizer, *, init_params, make_forward, make_train_step,
                 mesh: Optional[ParallelMesh] = None):
        super().__init__()
        from ..runtime.ess import discover_devices

        self.cfg = cfg
        self.mesh = mesh if mesh is not None else build_parallel_mesh(
            devices=discover_devices(device)[:1])
        self.device = self.mesh.device
        if params is None:
            params = init_params(cfg, torch.Generator().manual_seed(seed))
        params = to_device(params, self.device)

        def frozen(tensors):
            return nn.ParameterDict({
                n: nn.Parameter(t, requires_grad=False)
                for n, t in tensors.items()})

        self.layers = frozen(params["layers"])
        self.top = frozen({n: t for n, t in params.items()
                           if n != "layers"})
        self._fwd = make_forward(cfg, self.mesh)
        self._step = make_train_step(cfg, self.mesh)
        self._optimizer = optimizer
        self.opt_state = None

    def params(self) -> Dict:
        """The parameter dict ``make_forward``'s function takes."""
        out = dict(self.top.items())
        out["layers"] = dict(self.layers.items())
        return out

    def forward(self, *batch) -> torch.Tensor:
        return self._fwd(self.params(), *batch)

    def train_step(self, *batch) -> torch.Tensor:
        """One optimizer step on the batch; returns the pre-update loss
        (detached)."""
        if self.opt_state is None:
            self.opt_state = self._optimizer(self.params())
        _, _, loss = self._step(self.params(), self.opt_state, *batch)
        return loss


class TpuLM(OneDeviceModel):
    """The TpuLM on one device (:class:`OneDeviceModel`): ``model(tokens,
    targets)`` is the eval loss, ``model.train_step(tokens, targets)``
    one step of ``optim.adamw(1e-3)`` (the optimizer of
    ``__graft_entry__._dryrun_one``); another optimizer goes through
    :func:`make_train_step`. With ``mesh`` the model runs sharded over
    its axes."""

    def __init__(self, cfg: ModelConfig, params: Optional[Dict] = None, *,
                 device=None, seed: int = 0,
                 mesh: Optional[ParallelMesh] = None):
        super().__init__(cfg, params, device, seed, adamw(1e-3),
                         init_params=init_params, make_forward=make_forward,
                         make_train_step=make_train_step, mesh=mesh)
