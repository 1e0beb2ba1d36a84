"""The port's MFU line (``bench.mfu_line``) and its FLOP count
(``models/flops.py``), on the CPU.

- The closed form against ``torch.utils.flop_counter.FlopCounterMode``
  over a CPU forward + backward through ring attention, exactly: the
  product part equals the counter's total less its count of the
  attention calls, and the attention part equals the counter's count of
  one ``ring_attention`` forward + backward (all S² pairs) per layer and
  microbatch times (S + 1) / (2 S), the causal share. Held at bench.py's
  CI config (dense) and with the switch-MoE FFN, with and without
  microbatches.
- The check values: ≈ 174 GFLOP a step at the chip config (167.5 of
  weight products, 6.5 of attention), ≈ 4.91 TFLOP at the full-width
  default config.
- The CI-size line runs on the CPU and is well formed, with ``mfu``
  null; the peak table; the jitter flag; the line's place in ``main``.
"""

import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from ompi_release_tpu_torch import bench as tbench
from ompi_release_tpu_torch.models import flops
from ompi_release_tpu_torch.models import transformer as ttfm
from ompi_release_tpu_torch.optim import leaves
from ompi_release_tpu_torch.parallel import cp

#: bench.py's CI config and batch
CI = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, head_dim=16,
          d_ff=128, max_seq=32, dtype=torch.float32, attn_impl="ring")
CI_BATCH = (2, 32)


def _counted(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("extra", [
    {}, dict(n_experts=4), dict(n_experts=4, capacity_factor=0.5),
    dict(n_experts=4, capacity_factor=4.0, microbatches=2)],
    ids=["dense", "moe", "moe-drops", "moe-microbatches"])
def test_closed_form_matches_flop_counter(extra):
    cfg = ttfm.ModelConfig(**CI, **extra)
    b, s = CI_BATCH
    params = ttfm.init_params(cfg, torch.Generator().manual_seed(0))
    ts = leaves(params)
    for t in ts:
        t.requires_grad_(True)
    tok = torch.as_tensor(np.random.RandomState(0).randint(0, cfg.vocab,
                                                           size=(b, s)))
    tgt = torch.roll(tok, -1, dims=1)
    step = _counted(lambda: torch.autograd.grad(
        ttfm.forward_loss(cfg, params, tok, tgt), ts))

    mb = b // cfg.microbatches
    q, k, v = (torch.randn(mb, cfg.n_heads, s, cfg.head_dim,
                           requires_grad=True) for _ in range(3))
    ring = _counted(lambda: torch.autograd.grad(
        cp.ring_attention(q, k, v, causal=True).sum(), (q, k, v)))
    ring_all = ring * cfg.n_layers * cfg.microbatches
    assert ring == 3 * 2 * 2 * mb * cfg.n_heads * cfg.head_dim * s * s

    assert flops.product_flops(cfg, b, s) == step - ring_all
    assert flops.attention_flops(cfg, b, s) == ring_all * (s + 1) // (2 * s)
    assert flops.train_step_flops(cfg, b, s) == (
        step - ring_all + flops.attention_flops(cfg, b, s))


def test_closed_form_check_values():
    chip, (b, s) = tbench._mfu_config(small=False)
    assert (chip.vocab, chip.d_model, chip.n_layers, chip.d_ff, chip.dtype,
            chip.attn_impl, b, s) == (2048, 512, 4, 2048, torch.bfloat16,
                                      "auto", 8, 256)
    shapes = ttfm.param_shapes(chip)
    shapes.update(shapes.pop("layers"))
    weights = sum(int(np.prod(shape)) for name, (shape, _) in shapes.items()
                  if not name.startswith("ln"))
    assert weights == 13_631_488
    assert flops.product_flops(chip, b, s) == 6 * weights * b * s
    assert flops.product_flops(chip, b, s) / 1e9 == pytest.approx(167.5,
                                                                  abs=0.1)
    assert flops.attention_flops(chip, b, s) / 1e9 == pytest.approx(6.47,
                                                                    abs=0.01)
    assert flops.train_step_flops(chip, b, s) / 1e9 == pytest.approx(
        174.0, abs=0.1)
    full = ttfm.ModelConfig()
    assert flops.product_flops(full, 8, 2048) / 1e12 == pytest.approx(
        4.085, abs=1e-3)
    assert flops.attention_flops(full, 8, 2048) / 1e12 == pytest.approx(
        0.825, abs=1e-3)
    assert flops.train_step_flops(full, 8, 2048) / 1e12 == pytest.approx(
        4.91, abs=0.01)


def test_mfu_line_on_the_cpu_is_well_formed():
    line = tbench.mfu_line("cpu", small=True, rounds=2)
    json.dumps(line)
    assert line["metric"] == "transformer_fwdbwd_step"
    assert line["unit"] == "TFLOP/s" and line["vs_baseline"] is None
    assert line["k"] == [2, 10] and line["sec_per_step"] > 0
    cfg, (b, s) = tbench._mfu_config(small=True)
    assert line["flops_per_step"] == flops.train_step_flops(cfg, b, s)
    assert line["value"] == pytest.approx(
        line["flops_per_step"] / line["sec_per_step"] / 1e12, rel=1e-2,
        abs=1e-3)
    assert line["mfu"] is None and line["peak_tflops"] is None
    assert line["device"] == line["device_kind"] == "cpu"
    assert line["power_limit"] is None
    assert "profile_one_step" not in line  # a device metric: card only
    assert "unstable" not in line


def test_mfu_line_flags_a_k_delta_inside_the_jitter(monkeypatch):
    """At the card's sizes a K-delta under ``UNSTABLE_DELTA_S`` reads as
    jitter: no value, no MFU (the CI config stands in for the chip's;
    the bound is raised so that any CPU delta falls under it)."""
    small = tbench._mfu_config(small=True)
    monkeypatch.setattr(tbench, "_mfu_config", lambda small_: small)
    monkeypatch.setattr(tbench, "_calibrate_k", lambda *a: (2, 3))
    monkeypatch.setattr(tbench, "UNSTABLE_DELTA_S", 1e9)
    line = tbench.mfu_line("cpu", small=False, rounds=2)
    assert line["unstable"] is True
    assert line["value"] is None and line["mfu"] is None


def test_peak_by_card_name():
    assert tbench.peak_flops("NVIDIA H100 PCIe") == 756e12
    assert tbench.peak_flops("NVIDIA H100 NVL") == 835e12
    assert tbench.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert tbench.peak_flops("NVIDIA A100-SXM4-80GB") is None
    assert tbench.peak_flops("cpu") is None


def test_main_prints_the_mfu_line_before_the_headline(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tbench, "run_suite", lambda dev: (
        [{"metric": "allreduce_8B"}], {"metric": "op_sum_256MiB_f32_hbm_bw"}))
    monkeypatch.setattr(tbench, "run_mesh_suite", lambda dev: (
        [{"metric": "mesh8_allreduce_8B"}],
        {"metric": "allreduce_256MiB_f32_busbw_8dev"}))
    monkeypatch.setattr(tbench, "mfu_line", lambda dev: {
        "metric": "transformer_fwdbwd_step"})
    try:
        assert tbench.main() == 0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    out = [json.loads(ln)["metric"]
           for ln in capsys.readouterr().out.splitlines()]
    # the mesh suite's lines and its headline follow the single-card
    # lines; the MFU line, then the single-card headline, come last
    assert out == ["allreduce_8B", "mesh8_allreduce_8B",
                   "allreduce_256MiB_f32_busbw_8dev",
                   "transformer_fwdbwd_step", "op_sum_256MiB_f32_hbm_bw"]
