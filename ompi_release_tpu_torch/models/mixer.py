"""TpuMixer — the MLP-Mixer, the second model family, on one device or
sharded over dp and tp.

Counterpart of ``ompi_release_tpu/models/mixer.py``: the same
configuration, parameter layout, layers, loss and train step. Each block
mixes tokens (an MLP across the patch axis, replicated over tp) and then
channels (the ``column_parallel`` / ``row_parallel`` FFN pair of
``parallel.tp``, sharded over tp: one psum per block); the head pools
the patches and classifies; the batch splits over dp. On a mesh the
per-rank code runs over the stacked layout of ``parallel/mesh_axes.py``
(``transformer.shard_params``' idiom); any axis but dp and tp must be 1,
as the reference refuses. All products are plain cuBLAS products: the
reference reaches no Pallas kernel here.

The reference's precisions are kept: token mixing takes the f32 product
of the bf16 values, GELUs it in f32 and multiplies by the f32-widened
``wt2`` (an f32 x f32 product); channel mixing rounds its first product
to the working type and GELUs it there (torch computes the GELU in f32
and rounds once, XLA on the CPU may round between its elementwise
steps: bf16 runs agree within a bf16 tolerance, f32 runs tightly).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..optim import sgd
from ..parallel import axes, tp as tp_mod
from ..parallel.mesh_axes import P, ParallelMesh
from .transformer import (
    OneDeviceModel, _map2, eval_fn, to_device, train_step_fn, tree_from_jax,
)


@dataclasses.dataclass(frozen=True)
class MixerConfig:
    n_patches: int = 64
    d_model: int = 128
    d_token: int = 64     # token-mixing hidden dim
    d_channel: int = 512  # channel-mixing hidden dim
    n_layers: int = 4
    n_classes: int = 10
    dtype: Any = torch.bfloat16

    def validate(self, mesh: ParallelMesh) -> None:
        ax = dict(mesh.shape)
        if self.d_channel % ax.get("tp", 1):
            raise ValueError("d_channel must divide by tp")
        for name in ("pp", "sp", "ep"):
            if ax.get(name, 1) != 1:
                raise ValueError(
                    f"TpuMixer parallelizes over dp/tp only; axis "
                    f"'{name}' must be 1 (got {ax[name]})")


def param_shapes(cfg: MixerConfig) -> Dict:
    """``{name: (shape, dtype)}`` of the parameter dict, ``layers``
    nested: the JAX ``init_params`` pytree's structure."""
    l, d, dt, f32 = cfg.n_layers, cfg.d_model, cfg.dtype, torch.float32
    return {
        "layers": {
            "ln1": ((l, d), f32),
            "wt1": ((l, cfg.n_patches, cfg.d_token), dt),
            "wt2": ((l, cfg.d_token, cfg.n_patches), dt),
            "ln2": ((l, d), f32),
            "wc1": ((l, d, cfg.d_channel), dt),
            "wc2": ((l, cfg.d_channel, d), dt),
        },
        "ln_f": ((d,), f32),
        "head": ((d, cfg.n_classes), dt),
    }


def init_params(cfg: MixerConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Random parameters with the shapes, dtypes and scales of the JAX
    ``init_params`` (``mixer.py:69-93``): N(0, 1) in f32 times
    1/sqrt(fan-in), cast to ``cfg.dtype``; norms are f32 ones. Drawn on
    the CPU from ``generator`` (the numbers differ from JAX's), then
    moved to ``device``."""
    def make(name, shape, dtype):
        if name.startswith("ln"):
            return torch.ones(shape, dtype=dtype)
        x = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (x / math.sqrt(shape[-2])).to(dtype)

    shapes = param_shapes(cfg)
    params = {n: make(n, *sd) for n, sd in shapes.items() if n != "layers"}
    params["layers"] = {n: make(n, *sd)
                        for n, sd in shapes["layers"].items()}
    return to_device(params, device)


def params_from_jax(np_params: Dict, cfg: MixerConfig, device=None) -> Dict:
    """The JAX pytree (as numpy arrays) as the port's parameter dict,
    value for value. Raises if a leaf is missing, extra, or of another
    shape or dtype than ``cfg`` gives it."""
    return to_device(tree_from_jax(np_params, param_shapes(cfg)), device)


def _layernorm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """No bias; eps 1e-6 inside the rsqrt; f32, then x's dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    g = axes.align(g, x.dim() - axes.lead(x))
    return ((x32 - mu) * torch.rsqrt(var + 1e-6) * g).to(x.dtype)


def _layer(lp: Dict, x: torch.Tensor) -> torch.Tensor:
    """One mixer block. x: (B, P, D) per rank."""
    # token mixing across patches: f32 product of the working-type
    # values, GELU in f32, then an f32 x f32 product (wt2 widened)
    h = _layernorm(x, lp["ln1"]).transpose(-2, -1)  # (B, D, P)
    h = axes.rank_matmul(h.float(), lp["wt1"].float())
    h = F.gelu(h, approximate="tanh")
    h = axes.rank_matmul(h, lp["wt2"].float())
    x = x + h.transpose(-2, -1).to(x.dtype)

    # channel mixing: the FFN pair, GELU in the working type
    h = _layernorm(x, lp["ln2"])
    h = tp_mod.column_parallel(h, lp["wc1"])
    h = F.gelu(h, approximate="tanh")
    h = tp_mod.row_parallel(h, lp["wc2"])
    return x + h.to(x.dtype)


def forward_loss(cfg: MixerConfig, params: Dict, patches: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """patches: (B, P, D) pre-embedded patch features; labels: (B,)
    int. Returns the mean cross-entropy (an f32 scalar)."""
    x = patches.to(cfg.dtype)
    n = axes.lead(x)
    layers = params["layers"]
    for i in range(layers["ln1"].shape[n]):
        x = _layer({k: t.select(n, i) for k, t in layers.items()}, x)
    x = _layernorm(x, params["ln_f"])
    pooled = x.float().mean(dim=-2)  # (B, D)
    logits = axes.rank_matmul(pooled, params["head"].float())
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    total = nll.shape[-1] * axes.axis_size_or_1("dp")
    return axes.psum(nll.sum(dim=-1) / total, "dp")


def param_specs(cfg: MixerConfig) -> Dict:
    """``PartitionSpec``s of the parameter dict (``mixer.py:94-107``):
    the channel-mixing pair split over tp, the rest replicated."""
    return {
        "layers": {"ln1": P(), "wt1": P(), "wt2": P(), "ln2": P(),
                   "wc1": P(None, None, "tp"),   # column parallel
                   "wc2": P(None, "tp", None)},  # row parallel
        "ln_f": P(),
        "head": P(),
    }


def batch_spec():
    return P("dp")


def shard_params(params: Dict, cfg: MixerConfig,
                 mesh: ParallelMesh) -> Dict:
    """The parameters' stacked per-rank views under :func:`param_specs`
    (``transformer.shard_params``)."""
    return _map2(mesh.stack, params, param_specs(cfg))


def sharded_loss(cfg: MixerConfig, mesh: ParallelMesh, params: Dict,
                 patches: torch.Tensor, labels: torch.Tensor
                 ) -> torch.Tensor:
    """The scalar loss over ``mesh``'s ranks: the batch split over dp."""
    with mesh:
        loss = forward_loss(cfg, shard_params(params, cfg, mesh),
                            mesh.stack(patches, batch_spec()),
                            mesh.stack(labels, batch_spec()))
    return loss.reshape(())


def _loss_on(cfg: MixerConfig, mesh: ParallelMesh):
    if mesh.size == 1:
        return partial(forward_loss, cfg)
    return partial(sharded_loss, cfg, mesh)


def make_forward(cfg: MixerConfig, mesh: ParallelMesh):
    """``fn(params, patches, labels) -> scalar loss`` on ``mesh``'s
    device, under ``torch.inference_mode()``; patches and labels may be
    numpy arrays or tensors."""
    cfg.validate(mesh)
    return eval_fn(_loss_on(cfg, mesh), mesh.device)


def make_train_step(cfg: MixerConfig, mesh: ParallelMesh):
    """The train step on ``mesh``'s device: ``step(params, opt_state,
    patches, labels) -> (params, opt_state, loss)`` with ``opt_state =
    optim.sgd(lr)(params)`` (or ``optim.adamw``), as
    ``transformer.make_train_step``: the parameters and the state are
    updated in place, ``loss`` is the detached pre-update loss."""
    cfg.validate(mesh)
    return train_step_fn(_loss_on(cfg, mesh), mesh.device)


class TpuMixer(OneDeviceModel):
    """The Mixer on one device (``transformer.OneDeviceModel``):
    ``model(patches, labels)`` is the eval loss,
    ``model.train_step(patches, labels)`` one step of ``optim.sgd(lr)``
    (``lr`` 0.1 by default, the JAX bf16 test's rate). With ``mesh``
    (dp and tp only) the model runs sharded over its axes."""

    def __init__(self, cfg: MixerConfig, params: Optional[Dict] = None, *,
                 device=None, seed: int = 0, lr: float = 0.1,
                 mesh: Optional[ParallelMesh] = None):
        super().__init__(cfg, params, device, seed, sgd(lr),
                         init_params=init_params, make_forward=make_forward,
                         make_train_step=make_train_step, mesh=mesh)
