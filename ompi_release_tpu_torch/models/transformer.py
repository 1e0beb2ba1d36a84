"""TpuLM — the flagship decoder-only transformer on one card: the eval
forward and the train step.

Counterpart of ``ompi_release_tpu/models/transformer.py``: the same
configuration, parameter layout, layers, loss and train step, with every
mesh axis of size 1 (``parallel.mesh_axes``). The path
is tokens -> embedding -> n_layers blocks (RMSNorm, RoPE, q/k/v,
causal attention, output projection, tanh-GELU MLP) -> final RMSNorm ->
tied-embedding cross-entropy -> mean loss.

Attention (``attn_impl``, the JAX meaning): ``"flash"`` is
``ops.flash_attention`` (the CUDA kernel on the card, its plain twin on
the CPU), ``"ring"`` is ``parallel.cp.ring_attention``, and ``"auto"``
is the kernel on a CUDA device (sp = 1 on one card) and ring elsewhere,
as JAX picks the Pallas kernel on a TPU and ring elsewhere.

Parameters are a dict of tensors shaped as the JAX pytree, per-layer
weights stacked on a leading ``n_layers`` axis; ``params_from_jax``
carries a JAX pytree (as numpy arrays) over. The gradient is autograd's
through the same forward, with ``flash_attention``'s backward the flash
backward kernels (their plain twins on the CPU). The switch-MoE FFN
(``n_experts > 0``) and axes > 1 are later slices.
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
from ..parallel import cp, pp as pp_mod, tp as tp_mod
from ..parallel.mesh_axes import ParallelMesh, build_parallel_mesh
from ..utils.errors import ErrorCode, MPIError


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab: int = 32000
    d_model: int = 512
    n_layers: int = 8
    n_heads: int = 8
    head_dim: int = 64
    d_ff: int = 2048
    max_seq: int = 2048
    n_experts: int = 0  # 0 = dense FFN; >0 = switch-MoE (not ported yet)
    capacity_factor: float = 1.25  # read by the MoE layer (not ported yet)
    microbatches: int = 1  # microbatch count of the pp schedule
    remat: bool = False  # checkpoint the trunk: recompute in the backward
    dtype: Any = torch.bfloat16
    rope_base: float = 10000.0
    # "auto" = the CUDA flash kernel on a card, ring attention elsewhere;
    # "ring" / "flash" force one path (flash runs its plain twin on CPU)
    attn_impl: str = "auto"

    def __post_init__(self):
        if self.n_experts:
            raise MPIError(ErrorCode.ERR_NOT_AVAILABLE,
                           "n_experts > 0 (switch-MoE) is not ported: "
                           "ROADMAP slice 3 item 15")
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


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def param_shapes(cfg: ModelConfig) -> Dict:
    """``{name: (shape, dtype)}`` of the parameter dict, ``layers``
    nested: the JAX ``init_params`` pytree's structure."""
    d, l, dt = cfg.d_model, cfg.n_layers, cfg.dtype
    hdim = cfg.n_heads * cfg.head_dim
    f32 = torch.float32
    return {
        "embed": ((cfg.vocab, d), dt),
        "ln_f": ((d,), f32),
        "layers": {
            "ln1": ((l, d), f32),
            "wq": ((l, d, hdim), dt),
            "wk": ((l, d, hdim), dt),
            "wv": ((l, d, hdim), dt),
            "wo": ((l, hdim, d), dt),
            "ln2": ((l, d), f32),
            "w1": ((l, d, cfg.d_ff), dt),
            "w2": ((l, cfg.d_ff, d), dt),
        },
    }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Random parameters with the shapes, dtypes and scales of the JAX
    ``init_params`` (``transformer.py:82-114``): N(0, 1) in f32 times
    0.02 for the embedding and 1/sqrt(fan-in) for the weights, cast to
    ``cfg.dtype``; norms are f32 ones. Drawn on the CPU from
    ``generator`` (the numbers differ from JAX's), then moved."""
    def draw(shape, dtype, scale):
        x = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (x * scale).to(dtype)

    def make(name, shape, dtype):
        if name.startswith("ln"):
            return torch.ones(shape, dtype=dtype)
        return draw(shape, dtype, 0.02 if name == "embed"
                    else 1.0 / math.sqrt(shape[-2]))

    shapes = param_shapes(cfg)
    params = {n: make(n, *sd) for n, sd in shapes.items() if n != "layers"}
    params["layers"] = {n: make(n, *sd)
                        for n, sd in shapes["layers"].items()}
    return _to_device(params, device)


def _to_device(params: Dict, device) -> Dict:
    if device is None:
        return params
    out = {n: t.to(device) for n, t in params.items() if n != "layers"}
    out["layers"] = {n: t.to(device) for n, t in params["layers"].items()}
    return out


def _from_numpy(a) -> torch.Tensor:
    a = np.array(a)  # a writable copy: device_get's arrays are read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes: reinterpret the 16 bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(np_params: Dict, cfg: ModelConfig, device=None) -> Dict:
    """The JAX pytree (``init_params`` output as numpy arrays, e.g.
    ``jax.device_get(params)``) as the port's parameter dict, value for
    value. Raises if a leaf is missing, extra, or of another shape or
    dtype than ``cfg`` gives it."""
    shapes = param_shapes(cfg)

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

    return _to_device(convert(np_params, shapes, ""), device)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _rmsnorm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + 1e-6)
    return (x32 * r * g).to(x.dtype)


def _rope(x: torch.Tensor, pos: torch.Tensor, base: float) -> torch.Tensor:
    """x: (mb, S, H, Dh); pos: (S,) positions. Non-interleaved halves,
    angles in f32."""
    half = x.shape[-1] // 2
    freq = torch.pow(
        torch.tensor(base, dtype=torch.float32),
        -torch.arange(half, dtype=torch.float32) / half).to(x.device)
    ang = pos[:, None].float() * freq[None]  # (S, half)
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _use_flash(cfg: ModelConfig, device: torch.device) -> bool:
    """The JAX rule with sp = 1: "flash", or "auto" on the accelerator
    (here a CUDA device, there a TPU)."""
    return cfg.attn_impl == "flash" or (
        cfg.attn_impl == "auto" and device.type == "cuda")


def _layer(cfg: ModelConfig, lp: Dict, x: torch.Tensor) -> torch.Tensor:
    """One transformer block. x: (mb, S, D)."""
    mb, s, _ = x.shape
    pos = torch.arange(s, device=x.device)
    h = _rmsnorm(x, lp["ln1"])
    hl = lp["wq"].shape[-1] // cfg.head_dim

    def qkv(w):
        return tp_mod.column_parallel(h, w).reshape(mb, s, hl, cfg.head_dim)

    q = _rope(qkv(lp["wq"]), pos, cfg.rope_base)
    k = _rope(qkv(lp["wk"]), pos, cfg.rope_base)
    v = qkv(lp["wv"])
    # (mb, H, S, Dh): the JAX vmap over mb written out as a batch dim
    q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if _use_flash(cfg, x.device):
        attn = flash_attention(q, k, v, True)
    else:
        attn = cp.ring_attention(q, k, v, causal=True)
    attn = attn.transpose(1, 2).reshape(mb, s, hl * cfg.head_dim)
    x = x + tp_mod.row_parallel(attn, lp["wo"])

    h2 = _rmsnorm(x, lp["ln2"])
    u = tp_mod.column_parallel(h2, lp["w1"])
    # jax.nn.gelu's default is the tanh approximation
    u = F.gelu(u.float(), approximate="tanh").to(x.dtype)
    return x + tp_mod.row_parallel(u, lp["w2"])


def _trunk(cfg: ModelConfig, stage_layers: Dict,
           x: torch.Tensor) -> torch.Tensor:
    """The stage's layers in order (the JAX ``lax.scan`` over the
    leading axis of the stacked weights)."""
    for i in range(stage_layers["ln1"].shape[0]):
        x = _layer(cfg, {n: t[i] for n, t in stage_layers.items()}, x)
    return x


def forward_loss(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                 targets: torch.Tensor) -> torch.Tensor:
    """Scalar mean cross-entropy. tokens/targets: (B, S) int."""
    b, s = tokens.shape
    m = cfg.microbatches
    if b % m:
        raise ValueError(f"batch {b} does not split into {m} microbatches")
    emb = tp_mod.vocab_parallel_embedding(tokens,
                                          params["embed"]).to(cfg.dtype)
    x_mb = emb.reshape(m, b // m, s, cfg.d_model)
    y = pp_mod.pipeline(partial(_trunk, cfg), params["layers"], x_mb,
                        remat=cfg.remat)
    h = _rmsnorm(y.reshape(b, s, cfg.d_model), params["ln_f"])
    nll = tp_mod.vocab_parallel_xent(h.float(), params["embed"].float(),
                                     targets)
    return nll.sum() / (b * s)


def make_forward(cfg: ModelConfig, mesh: ParallelMesh):
    """The loss-evaluation forward (the flagship inference/eval path) on
    ``mesh``'s device: ``fn(params, tokens, targets) -> scalar loss``.
    Tokens and targets may be numpy arrays or tensors; the forward runs
    under ``torch.inference_mode()``."""
    cfg.validate(mesh)
    dev = mesh.device

    def fn(params: Dict, tokens, targets) -> torch.Tensor:
        with torch.inference_mode():
            return forward_loss(cfg, params, torch.as_tensor(tokens,
                                                             device=dev),
                                torch.as_tensor(targets, device=dev))

    return fn


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
    dev = mesh.device

    def step(params: Dict, opt_state, tokens, targets):
        opt_state.zero_grad(set_to_none=True)
        loss = forward_loss(cfg, params, torch.as_tensor(tokens, device=dev),
                            torch.as_tensor(targets, device=dev))
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return step


class TpuLM(nn.Module):
    """The model on one device: parameters (random from ``seed`` unless
    given), the eval forward and the train step. ``device`` defaults to
    ``cuda:0``; without CUDA it raises ``ERR_NOT_AVAILABLE`` unless the
    caller asks for ``device="cpu"``, as ``init()`` does. The parameters
    are frozen until the first :meth:`train_step`, which makes them
    trainable and builds the state of ``optim.adamw(1e-3)`` (the
    optimizer of ``__graft_entry__._dryrun_one``); another optimizer goes
    through :func:`make_train_step`."""

    def __init__(self, cfg: ModelConfig, params: Optional[Dict] = None, *,
                 device=None, seed: int = 0):
        super().__init__()
        from ..runtime.ess import discover_devices

        self.cfg = cfg
        self.mesh = build_parallel_mesh(devices=discover_devices(device)[:1])
        self.device = self.mesh.device
        if params is None:
            params = init_params(cfg, torch.Generator().manual_seed(seed))
        params = _to_device(params, self.device)

        def frozen(tensors):
            return nn.ParameterDict({
                n: nn.Parameter(t, requires_grad=False)
                for n, t in tensors.items()})

        self.layers = frozen(params["layers"])
        self.top = frozen({n: t for n, t in params.items()
                           if n != "layers"})
        self._fwd = make_forward(cfg, self.mesh)
        self._step = make_train_step(cfg, self.mesh)
        self.opt_state = None

    def params(self) -> Dict:
        """The parameter dict ``make_forward``'s function takes."""
        out = dict(self.top.items())
        out["layers"] = dict(self.layers.items())
        return out

    def forward(self, tokens, targets) -> torch.Tensor:
        return self._fwd(self.params(), tokens, targets)

    def train_step(self, tokens, targets) -> torch.Tensor:
        """One optimizer step on (B, S) tokens/targets; returns the
        pre-update loss (detached)."""
        if self.opt_state is None:
            self.opt_state = adamw(1e-3)(self.params())
        _, _, loss = self._step(self.params(), self.opt_state, tokens,
                                targets)
        return loss
