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
  tokens/s. Without CUDA it exits 2.

``dryrun_multichip`` waits for the multi-card slice.
"""

from __future__ import annotations

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
    import dataclasses

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


def main(argv=None) -> int:
    train = "--train" in (sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("entry: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from .bench import card
    from .models.transformer import ModelConfig, TpuLM
    from .ops import cuda_op

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in f32
    cuda_op.build()
    model = TpuLM(ModelConfig(), seed=0)
    name, limit = card(model.device)
    tokens = EVAL_BATCH * EVAL_SEQ
    if train:
        runs = run_train(model, 1 + TRAIN_STEPS)[1:]  # after one warm-up
        metric, key = "tpulm_train_step", "step"
    else:
        run_eval(model, n_batches=1, seed=100)  # warm-up: cuBLAS, kernels
        runs = run_eval(model)
        metric, key = "tpulm_eval_batch", "batch"
    for i, (loss, ms) in enumerate(runs):
        print(json.dumps({"metric": metric, key: i, "loss": loss, "ms": ms,
                          "tokens_per_s": tokens / (ms * 1e-3),
                          "device": name, "power_limit": limit}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
