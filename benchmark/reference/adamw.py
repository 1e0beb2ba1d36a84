"""optax's ``adamw`` in float32 for a reference train step: the moments
start at zero, bias-corrected, and the decay is added to the update
(``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``)."""

import torch

#: optax.adamw's defaults
BETAS = (0.9, 0.999)
EPS = 1e-8
WEIGHT_DECAY = 1e-4


class AdamW:
    """The optimizer over a list of float32 tensors, updated in place."""

    def __init__(self, params, lr: float):
        self.params, self.lr, self.t = list(params), float(lr), 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads) -> None:
        b1, b2 = BETAS
        self.t += 1
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = m / (1 - b1 ** self.t)
            v_hat = v / (1 - b2 ** self.t)
            p.sub_(self.lr * (m_hat / (v_hat.sqrt() + EPS)
                              + WEIGHT_DECAY * p))
