"""The optimizers the flagship model's callers pass, as small factories.

Counterparts of the two optax transforms the JAX package's callers hand
``make_train_step``: ``optax.sgd(lr)`` (``tests/test_models.py``) and
``optax.adamw(lr)`` (``__graft_entry__._dryrun_one``). Each factory
returns a function ``params -> torch.optim.Optimizer`` that plays
optax's ``init``: the optimizer is the state, built over the leaves of
the parameter dict, which it makes trainable and updates in place where
optax returns new arrays.

``adamw`` takes optax's defaults, not ``torch.optim.AdamW``'s: betas
(0.9, 0.999), eps 1e-8 and **weight_decay 1e-4** (torch's own default is
1e-2). optax's additive decay ``p - lr * (u + wd * p)`` equals torch's
``p * (1 - lr * wd) - lr * u`` up to rounding, and for bf16 parameters
both keep the moments in bf16 (optax's ``mu_dtype=None``).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

#: optax.adamw's defaults
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4

Optimizer = Callable[[Dict], torch.optim.Optimizer]


def leaves(params: Dict) -> List[torch.Tensor]:
    """The tensors of a (nested) parameter dict, in sorted key order."""
    out = []
    for name in sorted(params):
        t = params[name]
        out.extend(leaves(t) if isinstance(t, dict) else [t])
    return out


def _trainable(params: Dict) -> List[torch.Tensor]:
    ts = leaves(params)
    for t in ts:
        t.requires_grad_(True)
    return ts


def sgd(lr: float) -> Optimizer:
    """``optax.sgd(lr)``: ``p - lr * g``."""
    return lambda params: torch.optim.SGD(_trainable(params), lr=lr)


def adamw(lr: float) -> Optimizer:
    """``optax.adamw(lr)`` with optax's defaults."""
    return lambda params: torch.optim.AdamW(
        _trainable(params), lr=lr, betas=ADAMW_BETAS, eps=ADAMW_EPS,
        weight_decay=ADAMW_WEIGHT_DECAY)
