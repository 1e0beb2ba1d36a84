"""The train-step kind on the CPU, on the stand-in cell (the port's
TpuLM, dense at its tiny size, on a dp x ep mesh; ``standin.py``)
through its test-only plain reference: the cell comes out correct, its
control and each planted fault do not, the end-to-end readings are the
sums they should be, and the measuring process loads no JAX.

The stand-in is laid over a copy of the benchmark as a checkout
(``standin.make_tree``), where the harness finds its files by name as
it finds any cell's. One process there makes every run of ``CASES``
(``main``), and each test reads its own."""

import importlib.util
import json
import subprocess
import sys
import time

import pytest
import torch

import control
import harness
import standin
import trainstep

#: case -> (program, seed, traced)
CASES = {
    "port": ("port", 2**31 + 17, False),
    "traced": ("port", 2**31 + 17, True),
    **{f"control.{s}": ("control", s, False) for s in (11, 12, 2**31 + 13)},
    **{f"fault.{f}": (f, 2**31 + 17, False)
       for f in ("stale", "ascent", "half", "no_exchange", "skip_mlp")},
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's result line, from one process in a stand-in tree."""
    tree = standin.make_tree(tmp_path_factory.mktemp("step") / "tree")
    code = ("import sys\n"
            "sys.path[:0] = ['benchmark', 'benchmark/tests']\n"
            "import test_harness_step\n"
            "test_harness_step.main(sys.argv[1:])\n")
    res = subprocess.run([sys.executable, "-c", code, *CASES], cwd=tree,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(json.loads(line) for line in res.stdout.splitlines()
                if line.startswith("["))


def _reference():
    path = standin.DATA / "reference" / "tpulm_standin.py"
    spec = importlib.util.spec_from_file_location("standin_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_step_cell_is_correct(runs):
    r = runs["port"]
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["checks"]) == set(_reference().LIMITS) | {
        "outputs_compared"}
    assert r["checks"]["outputs_compared"]["value"] == 3
    assert list(r)[-1] == "checks"
    # no published peak on the CPU: mfu is not measured there
    assert set(r["metrics"]) == {"tokens_per_s", "peak_mem_GiB", "setup_s"}


def test_traced_step_cell_is_correct(runs):
    r = runs["traced"]
    assert r["correct"], r["checks"]
    assert r["attempted"] == 3
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("case", [c for c in CASES
                                  if c.startswith("control.")])
def test_control_is_not_correct(runs, case):
    assert not runs[case]["correct"], runs[case]["checks"]


def _stale(world, model):
    """A step that leaves the parameters as they were."""
    step = trainstep.program_for(world, model)

    def call(params, opt, tokens, targets):
        kept = [t.detach().clone() for t in trainstep.leaves(params)]
        loss = step(params, opt, tokens, targets)
        with torch.no_grad():
            for t, k in zip(trainstep.leaves(params), kept):
                t.copy_(k)
        return loss
    return call


def _ascent(world, model):
    """The update turned round: each step moves the parameters as far
    the other way."""
    step = trainstep.program_for(world, model)

    def call(params, opt, tokens, targets):
        kept = [t.detach().clone() for t in trainstep.leaves(params)]
        loss = step(params, opt, tokens, targets)
        with torch.no_grad():
            for t, k in zip(trainstep.leaves(params), kept):
                t.copy_(2 * k - t)
        return loss
    return call


def _half(world, model):
    """Half of the batch left out, the mean taken over the rest."""
    step = trainstep.program_for(world, model)

    def call(params, opt, tokens, targets):
        half = tokens.shape[0] // 2
        return step(params, opt, tokens[:half], targets[:half])
    return call


def _no_exchange(world, model):
    """The loss's sum over the batch's ranks left out: rank 0's part."""
    from ompi_release_tpu_torch.parallel import axes

    def rank0(x, axis_name):
        mesh, wide = axes._wide(axis_name)
        for a in wide:
            x = x.narrow(mesh.axis_dim(a), 0, 1)
        return x

    step = trainstep.program_for(world, model)

    def call(*args):
        psum, axes.psum = axes.psum, rank0
        try:
            return step(*args)
        finally:
            axes.psum = psum
    return call


def _skip_mlp(world, model):
    """The first layer's MLP left out (its output weight held at 0)."""
    from ompi_release_tpu_torch.models import transformer
    from ompi_release_tpu_torch.parallel import axes

    def trunk(cfg, stage_layers, x):
        n = axes.lead(x)
        for i in range(stage_layers["ln1"].shape[n]):
            lp = {k: t.select(n, i) for k, t in stage_layers.items()}
            if i == 0:
                lp["w2"] = torch.zeros_like(lp["w2"])
            x = transformer._layer(cfg, lp, x)
        return x

    step = trainstep.program_for(world, model)

    def call(*args):
        orig, transformer._trunk = transformer._trunk, trunk
        try:
            return step(*args)
        finally:
            transformer._trunk = orig
    return call


FAULTS = {"stale": _stale, "ascent": _ascent, "half": _half,
          "no_exchange": _no_exchange, "skip_mlp": _skip_mlp}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(runs, fault):
    r = runs[f"fault.{fault}"]
    assert not r["correct"], (fault, r["checks"])


def test_tokens_per_s_and_mfu_readings():
    run = {"latencies": [0.25, 0.5, 0.25], "tokens": 3 * 16384,
           "model_flops": 3 * 2.0e14, "peak_flops": 1e15,
           "memory_peak_bytes": 0, "setup_s": 1.0}
    assert harness.end_to_end("tokens_per_s", run) == pytest.approx(49152)
    assert harness.end_to_end("mfu", run) == pytest.approx(60.0)
    assert harness.end_to_end("mfu", dict(run, peak_flops=None)) is None


def test_step_flops_and_peak_are_the_benchmarks():
    model = {"config": {"vocab": 8, "d_model": 4, "n_layers": 2,
                        "n_heads": 2, "head_dim": 2, "d_ff": 6,
                        "n_experts": 0}}
    # 6 x tokens x (layers x (4 d hd + 2 d f) + d V) + attention
    want = 6 * 6 * (2 * (4 * 4 * 4 + 2 * 4 * 6) + 4 * 8) \
        + 6 * 2 * 2 * 2 * 4 * 3 * 4 // 2
    assert _reference().step_flops(model, 2, 3) == want
    import peaks

    assert peaks.flops_per_s("NVIDIA H100 80GB HBM3", "bfloat16") == 989e12
    assert peaks.flops_per_s("cpu", "bfloat16") is None


def test_a_step_run_loads_no_jax(runs):
    assert not set(runs["modules"]) & set(harness.FORBIDDEN)
    assert "ompi_release_tpu_torch" in runs["modules"]


def main(cases) -> None:
    """Runs each case on the CPU at the stand-in's tiny size and prints
    ``[case, result]`` a line, then ``["modules", top-level names]``."""
    from ompi_release_tpu_torch.runtime import runtime

    tiny = json.loads((harness.HERE / "tests" / "tiny"
                       / f"{standin.WORKLOAD}.json").read_text())
    programs = {"port": None, "control": control.control_step, **FAULTS}
    for case in cases:
        program, seed, trace = CASES[case]
        try:
            r = harness.run(standin.WORKLOAD, seed, 0.2, trace,
                            t_start=time.perf_counter(), device="cpu",
                            overrides=tiny, program=programs[program])
        finally:
            runtime._reset_for_tests()
        print(json.dumps([case, r]), flush=True)
    print(json.dumps(["modules", sorted({m.split(".")[0]
                                         for m in sys.modules})]))
