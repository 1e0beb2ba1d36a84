"""Entry points of the flagship model.

Counterpart of ``__graft_entry__.py``:

- :func:`entry` returns ``(fn, args)``: the TpuLM eval forward (loss) on
  one device at the same tiny config and batch as ``__graft_entry__.
  entry()``. The weights are drawn from a ``torch.Generator`` seeded 0,
  so the numbers differ from JAX's; ``models.params_from_jax`` carries
  JAX's over.
- :func:`train_entry` returns ``(step, args)``: one train step of
  ``__graft_entry__._dryrun_one`` at every axis 1 (the tiny config,
  ``adamw(1e-3)``, a (4, 16) batch) on one device.
- ``python -m ompi_release_tpu_torch.entry`` runs the full-width eval on
  the card (``ModelConfig``'s defaults: vocab 32000, d_model 512, 8
  layers, 8 x 64 heads, d_ff 2048, bf16) over 3 batches of (8, 2048)
  tokens and prints the loss, ms per batch and tokens/s, each line
  naming the card. With ``--train`` it runs the full-width train step
  instead: ``adamw(1e-3)`` on one fixed (8, 2048) batch from seed 0, one
  warm-up step and then 6 steps, each printing its loss, ms and
  tokens/s. ``--experts N`` takes the switch-MoE TpuLM instead (the
  same defaults with ``n_experts=N`` and ``capacity_factor`` 1.25; the
  repo's expert count is 4). ``--mixer`` trains the full-width default
  ``MixerConfig`` (64 patches, d_model 128, d_token 64, d_channel 512, 4
  layers, 10 classes, bf16) on one fixed batch of 1,024 random patch
  tensors and labels from seed 0 with ``sgd(0.1)``: one warm-up step,
  then 6 steps, each printing its loss, ms and samples/s. Every line
  carries the peak device memory so far. Without CUDA it exits 2.
  ``--mesh dp=2,pp=2,tp=2`` runs any of these sharded over a mesh of
  virtual ranks of the card (``parallel.build_parallel_mesh``; axes not
  named are 1): the TpuLM with ``microbatches=2`` when pp > 1 and
  ``capacity_factor`` 4.0 when ep > 1 (the dryrun's values), the Mixer
  over dp and tp only.
- :func:`dryrun_multichip` is ``__graft_entry__.dryrun_multichip``: the
  full train step (the tiny config, ``adamw(1e-3)``) over the two
  factorizations of n ranks that cover every axis > 1, one step each,
  as virtual ranks of one device (the card unless ``device`` says
  otherwise).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

#: the full-width eval: 3 batches of (8, 2048) tokens
EVAL_BATCHES = 3
EVAL_BATCH = 8
EVAL_SEQ = 2048
#: the full-width train run: steps after one warm-up step
TRAIN_STEPS = 6
#: the Mixer's full-width batch (patch tensors) and SGD rate
MIXER_BATCH = 1024
MIXER_LR = 0.1


def _tiny_cfg():
    from .models.transformer import ModelConfig

    return ModelConfig(vocab=64, d_model=32, n_layers=4, n_heads=4,
                       head_dim=8, d_ff=64, max_seq=32, dtype=torch.float32)


def _batch(cfg, b, s, seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab, size=(b, s)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def entry(device=None):
    """(fn, example_args): the flagship forward on one device
    (``cuda:0`` unless ``device`` says otherwise)."""
    from .models import transformer as tfm
    from .parallel.mesh_axes import build_parallel_mesh
    from .runtime.ess import discover_devices

    cfg = _tiny_cfg()
    mesh = build_parallel_mesh(devices=discover_devices(device)[:1])
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             mesh.device)
    tokens, targets = _batch(cfg, 4, 32)
    return tfm.make_forward(cfg, mesh), (
        params, torch.as_tensor(tokens, device=mesh.device),
        torch.as_tensor(targets, device=mesh.device))


def train_entry(device=None):
    """(step, example_args): ``__graft_entry__._dryrun_one``'s train step
    at every axis 1 on one device (``cuda:0`` unless ``device`` says
    otherwise): the tiny config with ``capacity_factor=4.0``,
    ``adamw(1e-3)`` and its (4, 16) batch. ``step(*args)`` returns
    ``(params, opt_state, loss)`` and updates the parameters in place."""
    from .models import transformer as tfm
    from .optim import adamw
    from .parallel.mesh_axes import build_parallel_mesh
    from .runtime.ess import discover_devices

    cfg = dataclasses.replace(_tiny_cfg(), capacity_factor=4.0)
    mesh = build_parallel_mesh(devices=discover_devices(device)[:1])
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             mesh.device)
    tokens, targets = _batch(cfg, 4, 16)
    return tfm.make_train_step(cfg, mesh), (
        params, adamw(1e-3)(params),
        torch.as_tensor(tokens, device=mesh.device),
        torch.as_tensor(targets, device=mesh.device))


def _dryrun_one(n: int, axes: dict, device=None) -> float:
    """One full train step over an n-rank mesh with the factorization
    ``axes`` (``__graft_entry__._dryrun_one``): returns its loss."""
    from .models import transformer as tfm
    from .optim import adamw
    from .parallel.mesh_axes import build_parallel_mesh
    from .runtime.ess import discover_devices

    cfg = dataclasses.replace(
        _tiny_cfg(), n_experts=4 if axes["ep"] > 1 else 0,
        capacity_factor=4.0, microbatches=2 if axes["pp"] > 1 else 1)
    mesh = build_parallel_mesh(devices=discover_devices(device)[:1], **axes)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             mesh.device)
    step = tfm.make_train_step(cfg, mesh)
    b = 4 * axes["dp"] * axes["ep"] * cfg.microbatches
    tokens, targets = _batch(cfg, b, 16 * axes["sp"])
    _, _, loss = step(params, adamw(1e-3)(params), tokens, targets)
    loss = float(loss)
    if not np.isfinite(loss):
        raise FloatingPointError(f"dryrun_multichip: non-finite loss {loss}")
    print(f"dryrun_multichip: n={n} axes={axes} loss={loss:.4f} OK")
    return loss


def dryrun_multichip(n_devices: int = 8, device=None):
    """The full train step over real multi-axis shardings of
    ``n_devices`` virtual ranks: the load-bearing factorization (tp, pp,
    dp first), then, at n divisible by 8, one that puts the remaining
    axes (sp, ep) > 1, so every axis runs > 1. Returns [(axes, loss)]."""
    axes = {"dp": 1, "pp": 1, "sp": 1, "ep": 1, "tp": 1}
    rem = n_devices
    for name in ("tp", "pp", "dp", "sp", "ep"):
        if rem % 2 == 0:
            axes[name] *= 2
            rem //= 2
    axes["dp"] *= rem  # leftover odd factor
    ran = [(axes, _dryrun_one(n_devices, axes, device))]
    if any(axes[k] == 1 for k in ("sp", "ep")) and n_devices % 8 == 0:
        axes2 = {"dp": n_devices // 4, "pp": 1, "sp": 2, "ep": 2, "tp": 1}
        ran.append((axes2, _dryrun_one(n_devices, axes2, device)))
    union = {k: max(a[k] for a, _ in ran) for k in axes}
    print(f"dryrun_multichip: axis coverage across {len(ran)} "
          f"factorization(s): {union} "
          f"({'ALL AXES > 1' if min(union.values()) > 1 else 'partial'})")
    return ran


def parse_mesh(text: str) -> dict:
    """``"dp=2,pp=2,tp=2"`` -> the axis sizes (unnamed axes 1)."""
    axes = {"dp": 1, "pp": 1, "sp": 1, "ep": 1, "tp": 1}
    for part in filter(None, text.split(",")):
        name, _, size = part.partition("=")
        if name.strip() not in axes or not size.strip().isdigit():
            raise ValueError(f"--mesh: {part!r} is not axis=size with an "
                             f"axis of {tuple(axes)}")
        axes[name.strip()] = int(size)
    return axes


def run_eval(model, n_batches: int = EVAL_BATCHES, batch: int = EVAL_BATCH,
             seq: int = EVAL_SEQ, seed: int = 0):
    """``n_batches`` eval batches of (batch, seq) random tokens through
    ``model`` (a ``TpuLM`` on the card), each timed on the host clock to
    a ``synchronize``. Returns ``[(loss, ms), ...]``."""
    out = []
    for i in range(n_batches):
        tokens, targets = _batch(model.cfg, batch, seq, seed=seed + i)
        tok = torch.as_tensor(tokens, device=model.device)
        tgt = torch.as_tensor(targets, device=model.device)
        torch.cuda.synchronize(model.device)
        t0 = time.perf_counter()
        loss = model(tok, tgt)
        torch.cuda.synchronize(model.device)
        out.append((float(loss), (time.perf_counter() - t0) * 1e3))
    return out


def run_train(model, n_steps: int, seed: int = 0):
    """``n_steps`` train steps of ``model`` (a ``TpuLM`` on the card) on
    one fixed (8, 2048) batch of random tokens from ``seed``, each timed
    on the host clock to a ``synchronize``. Returns ``[(loss, ms), ...]``
    (the pre-update loss of each step)."""
    tokens, targets = _batch(model.cfg, EVAL_BATCH, EVAL_SEQ, seed=seed)
    tok = torch.as_tensor(tokens, device=model.device)
    tgt = torch.as_tensor(targets, device=model.device)
    out = []
    for _ in range(n_steps):
        torch.cuda.synchronize(model.device)
        t0 = time.perf_counter()
        loss = model.train_step(tok, tgt)
        torch.cuda.synchronize(model.device)
        out.append((float(loss), (time.perf_counter() - t0) * 1e3))
    return out


def mixer_batch(cfg, b: int = MIXER_BATCH, seed: int = 0):
    """(patches (b, P, D) f32, labels (b,) int32) from numpy's seed."""
    rng = np.random.RandomState(seed)
    patches = rng.randn(b, cfg.n_patches, cfg.d_model).astype(np.float32)
    return patches, rng.randint(0, cfg.n_classes, size=(b,)).astype(np.int32)


def run_mixer_train(model, n_steps: int, seed: int = 0):
    """``n_steps`` train steps of ``model`` (a ``TpuMixer`` on the card)
    on one fixed batch of ``MIXER_BATCH`` from ``seed``, each timed on
    the host clock to a ``synchronize``. Returns ``[(loss, ms), ...]``."""
    patches, labels = (torch.as_tensor(a, device=model.device)
                       for a in mixer_batch(model.cfg, seed=seed))
    out = []
    for _ in range(n_steps):
        torch.cuda.synchronize(model.device)
        t0 = time.perf_counter()
        loss = model.train_step(patches, labels)
        torch.cuda.synchronize(model.device)
        out.append((float(loss), (time.perf_counter() - t0) * 1e3))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ompi_release_tpu_torch.entry")
    ap.add_argument("--train", action="store_true",
                    help="the train step instead of the eval forward")
    ap.add_argument("--experts", type=int, default=0,
                    help="switch-MoE TpuLM with this many experts")
    ap.add_argument("--mixer", action="store_true",
                    help="train the TpuMixer instead of the TpuLM")
    ap.add_argument("--mesh", default="",
                    help="shard over virtual ranks of the card, e.g. "
                         "dp=2,pp=2,tp=2")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    axes = parse_mesh(args.mesh)
    if not torch.cuda.is_available():
        print("entry: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from .bench import card
    from .models.mixer import MixerConfig, TpuMixer
    from .models.transformer import ModelConfig, TpuLM
    from .ops import cuda_op
    from .parallel.mesh_axes import build_parallel_mesh

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in f32
    cuda_op.build()
    mesh = build_parallel_mesh(**axes)
    if args.mixer:
        model = TpuMixer(MixerConfig(), seed=0, lr=MIXER_LR, mesh=mesh)
        runs = run_mixer_train(model, 1 + TRAIN_STEPS)[1:]
        metric, key, unit, per = "mixer_train_step", "step", \
            "samples_per_s", MIXER_BATCH
    else:
        cfg = ModelConfig(n_experts=args.experts,
                          microbatches=2 if axes["pp"] > 1 else 1)
        if axes["ep"] > 1:
            cfg = dataclasses.replace(cfg, capacity_factor=4.0)
        model = TpuLM(cfg, seed=0, mesh=mesh)
        unit, per = "tokens_per_s", EVAL_BATCH * EVAL_SEQ
        if args.train:
            runs = run_train(model, 1 + TRAIN_STEPS)[1:]  # after a warm-up
            metric, key = "tpulm_train_step", "step"
        else:
            run_eval(model, n_batches=1, seed=100)  # warm-up: cuBLAS
            runs = run_eval(model)
            metric, key = "tpulm_eval_batch", "batch"
        if args.experts:
            metric = metric.replace("tpulm", f"tpulm_moe{args.experts}")
    name, limit = card(model.device)
    for i, (loss, ms) in enumerate(runs):
        print(json.dumps({
            "metric": metric, key: i, "loss": loss, "ms": ms, "mesh": axes,
            unit: per / (ms * 1e-3),
            "peak_device_memory_GiB":
                torch.cuda.max_memory_allocated(model.device) / 2**30,
            "device": name, "power_limit": limit}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
