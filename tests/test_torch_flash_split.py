"""The numerical design of the bf16 flash backward on tensor cores,
emulated on the CPU and held to the card's gate.

The bf16 kernels (``csrc/flash_attn_bwd_wgmma.cu``) take S = Q·Kᵀ and
dP = dO·Vᵀ from the bf16 operands with f32 accumulation, form P and dS
in f32, and feed P and dS to the three output products as bf16 tensor-
core operands. Rounded once to bf16, P and dS lose too much: the
outputs then miss the gate that ``chip_smoke.py``'s ``grads_close`` and
``tests/test_torch_cuda_kernels.py`` hold the kernels to (within one
bf16 ulp plus 2e-4 of the f32 plain twin, on every element). Split
into a bf16 high part and a bf16 low part (``hi = bf16(x)``,
``lo = bf16(x - hi)``), each product taken twice and summed in f32,
they pass. :func:`_emulate` does that arithmetic with ``torch.matmul``
in f32 (exact products of bf16 operands, f32 sums) and rounds each
output once; the tests hold it against the plain twins
``_plain_bwd_dq`` / ``_plain_bwd_dkv`` under the gate, and show that
the single rounding fails it at S 2048.
"""

import numpy as np
import pytest
import torch

from ompi_release_tpu_torch.ops import flash_attention as fa

HEADS = 2


def _inputs(s, d, seed):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(HEADS, s, d).astype(np.float32))
                 .to(torch.bfloat16) for _ in range(4))


def _parts(x, split):
    """bf16 operand(s) standing in for the f32 tensor ``x``."""
    hi = x.to(torch.bfloat16)
    return (hi, (x - hi.float()).to(torch.bfloat16)) if split else (hi,)


def _emulate(q, k, v, lse, g, delta, causal, split):
    """(dq, dk, dv) with the bf16 kernels' operand rounding: products of
    bf16 operands summed in f32, the scale applied to S, dq and dk after
    their products, P and dS as bf16 operands (split into hi + lo, or
    rounded once), each output rounded once to bf16."""
    s, d = q.shape[-2:]
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    scale = fa._scale(d)
    pos = torch.arange(s)
    p = torch.where(fa._mask(pos, pos, s, causal),
                    torch.exp(qf @ kf.transpose(-1, -2) * scale
                              - lse[..., None]), 0.0)
    ds = p * (gf @ vf.transpose(-1, -2) - delta[..., None])

    def product(x, b, transpose):
        return sum((part.transpose(-1, -2) if transpose else part).float()
                   @ b for part in _parts(x, split))

    dq = product(ds, kf, False) * scale
    dk = product(ds, qf, True) * scale
    dv = product(p, gf, True)
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def _beyond_gate(got, want):
    """Elements of ``got`` farther from ``want`` than one bf16 ulp of
    ``want`` plus 2e-4 (``grads_close``'s bf16 rule)."""
    got, want = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30)))
                     - 7)
    return int(((got - want).abs() > ulp + 2e-4).sum())


def _case(s, d, causal, seed):
    q, k, v, g = _inputs(s, d, seed)
    out, lse = fa._plain_flash_forward(q, k, v, causal)
    args = (q, k, v, lse, g, fa._delta(out, g), causal)
    return args, (fa._plain_bwd_dq(*args), *fa._plain_bwd_dkv(*args))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [129, 2048])
@pytest.mark.parametrize("d", [64, 128])
def test_split_operands_pass_the_gate(causal, s, d):
    args, want = _case(s, d, causal, seed=s + d + causal)
    got = _emulate(*args, split=True)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _beyond_gate(a, b) == 0, name


@pytest.mark.parametrize("d", [64, 128])
def test_single_rounding_fails_the_gate(d):
    """P and dS rounded once to bf16: at S 2048 every gradient has
    elements beyond the gate, so the kernels split them."""
    args, want = _case(2048, d, True, seed=7 + d)
    got = _emulate(*args, split=False)
    counts = [_beyond_gate(a, b) for a, b in zip(got, want)]
    assert all(c > 0 for c in counts), counts
