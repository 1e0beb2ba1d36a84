"""Plain float32 reference of the port's dense TpuLM train step, for
the stand-in cell that sizes the train-step metrics (never a cell of
the benchmark: the TpuLM is no public family).

The architecture as ``ompi_release_tpu_torch/models/transformer.py``
states it with ``n_experts = 0``: tokens -> tied embedding ->
``n_layers`` blocks (RMSNorm with eps 1e-6, RoPE on non-interleaved
halves, q/k/v, causal softmax attention scaled by rsqrt(head_dim),
output projection, then the tanh-GELU MLP) -> RMSNorm -> the embedding
as the LM head -> the mean cross-entropy, worked out a rank's
microbatch at a time. Imports nothing of the port.
"""

import math

import torch
import torch.nn.functional as F

#: each number the check compares: (limit, reason). Set from the
#: stand-in's readings on the card at its own size: bfloat16 against this
#: float32 reference on 14 seeds (lower), the fp8 control and each
#: planted fault on 3 (upper: the control's least where it reads 3x the
#: lower, else the least fault that reads 10x)
LIMITS = {
    "loss1_rel_gap": (5e-5, "the first step's loss: sound runs read at "
                      "most 1.5e-5, half the batch 1.8e-4 and more (the "
                      "control reads from 5.8e-6 and sets none)"),
    "loss_rel_gap": (2.5e-3, "the worst step's loss: sound runs read at "
                     "most 7.4e-4, half the batch 8.0e-3 and more, the "
                     "update turned round 0.037 and more"),
    "grad_norm_gap": (2.2e-3, "the first gradient's unit norms: sound runs "
                      "read at most 7.1e-4, the control 5.8e-3 and more"),
    "grad_rel_gap": (0.065, "a drawn layer's first gradient: sound runs "
                     "read at most 0.021, the control 0.17 and more"),
    "change_norm_gap": (0.1, "the change over three steps: sound runs "
                        "read at most 6.6e-3, a step that leaves the "
                        "parameters as they were reads 1"),
    "change_dir_gap": (0.02, "the direction of a drawn layer's change: "
                       "sound runs read at most 5.1e-3, the control "
                       "0.075 and more, the update turned round 1.98"),
}

#: the precision below the model's bfloat16, which the control rounds
#: every product's operands to
CONTROL = "float8_e4m3fn"


def _shapes(model):
    c = model["config"]
    d, L, hd = c["d_model"], c["n_layers"], c["n_heads"] * c["head_dim"]
    dt, f32 = getattr(torch, c["dtype"]), torch.float32
    layers = {"ln1": ((L, d), f32), "wq": ((L, d, hd), dt),
              "wk": ((L, d, hd), dt), "wv": ((L, d, hd), dt),
              "wo": ((L, hd, d), dt), "ln2": ((L, d), f32)}
    if c["n_experts"]:
        raise ValueError("this reference is of the dense TpuLM only")
    layers.update(w1=((L, d, c["d_ff"]), dt), w2=((L, c["d_ff"], d), dt))
    return {"embed": ((c["vocab"], d), dt), "ln_f": ((d,), f32)}, layers


def init_params(model, generator, device):
    """N(0, 1) in float32 times 0.02 (embedding) or 1/sqrt(fan-in),
    rounded to the model's dtype; norms are ones, in float32."""
    dt = getattr(torch, model["config"]["dtype"])

    def make(name, shape, dtype):
        if name.startswith("ln"):
            return torch.ones(shape, dtype=dtype, device=device)
        scale = 0.02 if name == "embed" else 1.0 / math.sqrt(shape[-2])
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return x.mul_(scale).to(dt).to(dtype)

    top, layers = _shapes(model)
    out = {n: make(n, *sd) for n, sd in sorted(top.items())}
    out["layers"] = {n: make(n, *sd) for n, sd in sorted(layers.items())}
    return out


def units(tree):
    """Each layer's slice of each stacked tensor, and the tensors outside
    the layers."""
    out = {n: (None, tree[n]) for n in sorted(tree) if n != "layers"}
    for n in sorted(tree["layers"]):
        t = tree["layers"][n]
        for i in range(t.shape[0]):
            out[f"layers.{n}.{i}"] = (i, t[i])
    return out


def step_flops(model, batch, seq):
    """Model FLOPs of one step: 2 a multiply-add, three times for the
    forward and the backward, every product with a weight (the tied
    head too) and causal attention's two products over its S(S+1)/2
    pairs."""
    c = model["config"]
    d, f, hd = c["d_model"], c["d_ff"], c["n_heads"] * c["head_dim"]
    per_token = 4 * d * hd + 2 * d * f
    tokens = batch * seq
    products = 6 * tokens * (c["n_layers"] * per_token + d * c["vocab"])
    attention = 6 * c["n_layers"] * 2 * batch * hd * seq * (seq + 1) // 2
    return products + attention


def _rounder(dtype):
    """Rounds a product's operand to ``dtype`` (per-tensor scaled for
    8-bit floats, as an fp8 path scales), the gradient passing
    straight through; None rounds nothing."""
    if dtype is None:
        return lambda t: t
    fp8 = torch.finfo(dtype).bits == 8
    top = torch.finfo(dtype).max

    def q(t):
        if fp8:
            s = t.detach().abs().amax().clamp(min=1e-30) / top
            r = (t.detach() / s).to(dtype).float() * s
        else:
            r = t.detach().to(dtype).float()
        return t + (r - t.detach())
    return q


def _rmsnorm(x, g):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * g


def _rope(x, base):
    s, half = x.shape[-3], x.shape[-1] // 2
    freq = torch.pow(torch.tensor(base, dtype=torch.float32),
                     -torch.arange(half, dtype=torch.float32) / half)
    ang = torch.arange(s, dtype=torch.float32)[:, None] * freq
    cos, sin = (t.to(x.device)[:, None, :] for t in (ang.cos(), ang.sin()))
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def _block_nll(c, p, tokens, targets, q):
    """Summed -log p(target) of a block of rows (b, S)."""
    b, s = tokens.shape
    heads, hdim = c["n_heads"], c["head_dim"]
    x = p["embed"][tokens]
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    for i in range(c["n_layers"]):
        lp = {k: v[i] for k, v in p["layers"].items()}
        h = _rmsnorm(x, lp["ln1"])

        def proj(w):
            return (q(h) @ q(w)).view(b, s, heads, hdim)

        qh = _rope(proj(lp["wq"]), c["rope_base"]).transpose(1, 2)
        kh = _rope(proj(lp["wk"]), c["rope_base"]).transpose(1, 2)
        vh = proj(lp["wv"]).transpose(1, 2)
        scores = (q(qh) * (1.0 / math.sqrt(hdim))) @ q(kh).transpose(-1, -2)
        attn = torch.softmax(scores.masked_fill(~mask, -math.inf), -1)
        o = (q(attn) @ q(vh)).transpose(1, 2).reshape(b, s, heads * hdim)
        x = x + q(o) @ q(lp["wo"])
        u = F.gelu(q(_rmsnorm(x, lp["ln2"])) @ q(lp["w1"]),
                   approximate="tanh")
        x = x + q(u) @ q(lp["w2"])
    logits = q(_rmsnorm(x, p["ln_f"])) @ q(p["embed"]).T
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, targets[..., None])[..., 0]).sum()


def loss_and_grads(model, params, tokens, targets, dtype=None):
    """(mean loss, gradient tree) of float32 ``params`` on a (B, S) batch,
    a rank's microbatch at a time; ``dtype`` rounds every product's
    operands (the control)."""
    c, mesh = model["config"], model["mesh"]
    if any(mesh.get(a, 1) != 1 for a in ("pp", "sp", "tp")):
        raise ValueError("this reference splits the batch over dp and ep "
                         "only")
    blocks = mesh.get("dp", 1) * mesh.get("ep", 1) * c["microbatches"]
    rows = tokens.shape[0] // blocks
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        p = _tree(lambda t: t.detach().requires_grad_(True), params)
        q = _rounder(dtype)
        total = 0.0
        for r in range(blocks):
            sl = slice(r * rows, (r + 1) * rows)
            loss = _block_nll(c, p, tokens[sl], targets[sl], q)
            loss = loss / tokens.numel()
            loss.backward()
            total += float(loss.detach())
        return total, _tree(lambda t: t.grad if t.grad is not None
                            else torch.zeros_like(t), p)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _tree(f, tree):
    return {k: _tree(f, v) if isinstance(v, dict) else f(v)
            for k, v in tree.items()}
