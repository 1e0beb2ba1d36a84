"""The TpuLM train step's floating-point operations, in closed form.

The port has no compiler cost analysis to read, so the bench's MFU line
counts by hand, in model FLOPs: every product the step computes, 2·M·N·K
for an (M, K) x (K, N) product, once in the forward and once more in the
backward for each operand that carries a gradient, so x3 for every
product of a weight with an activation (the tied f32 LM head included);
no recompute and no elementwise work. Causal attention counts its
S(S+1)/2 unmasked (query, key) pairs: 2·B·H·Dh·S(S+1)/2 for each of its
two products, x3. The switch-MoE layer adds its router product (x3), its
experts' two products over every expert slot (E·C rows each, x3), the
combine einsum (x3) and the dispatch einsum, whose one-hot operand
carries no gradient (x2).

``tests/test_torch_mfu.py`` pins the product part against
``torch.utils.flop_counter.FlopCounterMode`` on a CPU step, and the
attention part against its count of one ``ring_attention`` forward and
backward (which computes all S² pairs).
"""

from __future__ import annotations


def product_flops(cfg, b: int, s: int) -> int:
    """FLOPs of the step's weight products (forward and backward) for a
    (b, s) batch of tokens under ``cfg`` (a transformer ``ModelConfig``),
    attention's own two products excluded."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    hd = cfg.n_heads * cfg.head_dim
    tokens = b * s
    per_layer = 3 * 2 * tokens * (4 * d * hd)  # q, k, v, o
    if cfg.n_experts:
        e = cfg.n_experts
        t = (b // cfg.microbatches) * s  # tokens per moe_layer call
        c = max(1, int(cfg.capacity_factor * t / e))
        per_call = (3 * 2 * t * d * e          # router
                    + 3 * 2 * e * c * 2 * d * f  # experts' two products
                    + 3 * 2 * t * e * c * d      # combine
                    + 2 * 2 * t * e * c * d)     # dispatch
        per_layer += cfg.microbatches * per_call
    else:
        per_layer += 3 * 2 * tokens * 2 * d * f
    return cfg.n_layers * per_layer + 3 * 2 * tokens * d * v  # + LM head


def attention_flops(cfg, b: int, s: int) -> int:
    """FLOPs of causal attention's two products (QK^T and PV) over the
    unmasked pairs, forward and backward, over all layers."""
    pairs = s * (s + 1) // 2
    return cfg.n_layers * 3 * 2 * (2 * b * cfg.n_heads * cfg.head_dim
                                   * pairs)


def train_step_flops(cfg, b: int, s: int) -> int:
    """Model FLOPs of one train step (forward + backward) on a (b, s)
    batch: :func:`product_flops` plus :func:`attention_flops`."""
    return product_flops(cfg, b, s) + attention_flops(cfg, b, s)
