"""The numerical design of the bf16 flash kernels on tensor cores,
emulated on the CPU and held to the card's gates.

The forward (``csrc/flash_attn_wgmma.cu``) takes S = Q·Kᵀ from the bf16
operands with f32 accumulation, applies the scale in f32 after the
product, keeps an online softmax over 64-key tiles with l summed from
the f32 P, and feeds P to O += P·V as a bf16 tensor-core operand. Rounded
once to bf16, P misses the forward's gate (``flash_close``: out within
one bf16 ulp plus 2e-5 of the f32 plain twin on every element, lse atol
1e-5) on some 10 % of the elements at S 2048; split into hi + lo it
passes. :func:`_emulate_fwd` follows that arithmetic; the tests hold it
against ``_plain_flash_forward``.

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


TILE = 64  # the forward kernel's k-tile (and q-tile) rows


def _emulate_fwd(q, k, v, causal, split):
    """(out, lse) with the bf16 forward kernel's arithmetic: over 64-key
    tiles, S from the bf16 operands in f32 with the scale after the
    product, the running max in log2 units (masked scores kept out of it
    by select), P = exp2(S scale log2 e - m2), l from the f32 P, P into
    P·V split into hi + lo (or rounded once to bf16), ``out`` rounded
    once to bf16 and ``lse = m2 ln 2 + log(max(l, 1e-30))``. A tile past
    the diagonal gives p = 0 and alpha = 1 to every row: running it is
    the same as skipping it."""
    s, d = q.shape[-2:]
    qf, kf, vf = (t.float() for t in (q, k, v))
    scale2 = fa._scale(d) * torch.tensor(np.log2(np.e), dtype=torch.float32)
    q_pos = torch.arange(s)
    m2 = torch.full(q.shape[:-1], fa.NEG_INF)
    l = torch.zeros(q.shape[:-1])
    acc = torch.zeros(qf.shape)
    for k0 in range(0, s, TILE):
        k_blk, v_blk = kf[:, k0:k0 + TILE], vf[:, k0:k0 + TILE]
        mask = fa._mask(q_pos, torch.arange(k0, k0 + k_blk.shape[1]), s,
                        causal)
        sc = qf @ k_blk.transpose(-1, -2)
        mx = torch.where(mask, sc, fa.NEG_INF).amax(dim=-1)
        m_new = torch.maximum(m2, mx * scale2)
        p = torch.where(mask, torch.exp2(sc * scale2 - m_new[..., None]), 0.0)
        alpha = torch.exp2(m2 - m_new)
        acc = acc * alpha[..., None]
        for part in _parts(p, split):
            acc = acc + part.float() @ v_blk
        l = l * alpha + p.sum(dim=-1)
        m2 = m_new
    l = torch.clamp_min(l, 1e-30)
    return (acc / l[..., None]).to(torch.bfloat16), \
        m2 * float(np.log(2.0)) + torch.log(l)


def _fwd_beyond_gate(got, want, got_lse, want_lse):
    """(elements of ``out`` beyond one bf16 ulp plus 2e-5, lse max |err|):
    ``flash_close``'s bf16 rule."""
    got, want = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30)))
                     - 7)
    return (int(((got - want).abs() > ulp + 2e-5).sum()),
            float((got_lse - want_lse).abs().max()))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [129, 2048])
@pytest.mark.parametrize("d", [64, 128])
def test_fwd_split_passes_the_gate(causal, s, d):
    q, k, v, _ = _inputs(s, d, seed=s + d + causal)
    want, want_lse = fa._plain_flash_forward(q, k, v, causal)
    got, got_lse = _emulate_fwd(q, k, v, causal, split=True)
    assert got.shape == want.shape and got.dtype == want.dtype
    beyond, lse_err = _fwd_beyond_gate(got, want, got_lse, want_lse)
    assert beyond == 0 and lse_err <= 1e-5, (beyond, lse_err)


@pytest.mark.parametrize("d", [64, 128])
def test_fwd_single_rounding_fails_the_gate(d):
    """P rounded once to bf16: at S 2048 more than 5 % of ``out`` lies
    beyond the gate (lse, from the f32 P, still holds), so the kernel
    splits P."""
    q, k, v, _ = _inputs(2048, d, seed=11 + d)
    want, want_lse = fa._plain_flash_forward(q, k, v, True)
    got, got_lse = _emulate_fwd(q, k, v, True, split=False)
    beyond, lse_err = _fwd_beyond_gate(got, want, got_lse, want_lse)
    assert beyond > 0.05 * want.numel(), beyond
    assert lse_err <= 1e-5
