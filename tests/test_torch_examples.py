"""The port's examples (``ompi_release_tpu_torch/examples/``) held against
the JAX package's acceptance programs (``examples/*_tpu.py``).

Each JAX example runs as ``tests/test_tools.py``'s ``TestExamples`` runs
it (driver mode, 8 forced host devices); the port's runs its
``main(device="cpu")`` on 8 virtual ranks. Their printed result lines
must be equal, line for line. ``unified_world_tpu`` also runs under the
port's ``tools.tpurun -n 2``, as the JAX test runs its own.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the port's examples that print what the JAX example prints (hello,
#: ring and allreduce print per-package text and have their own tests)
SAME_LINES = ["connectivity_tpu", "hello_oshmem_tpu", "ring_oshmem_tpu",
              "oshmem_reduction_tpu", "unified_world_tpu"]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("OMPITPU_") and k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


def _lines(text):
    return [ln.rstrip() for ln in text.splitlines() if ln.strip()]


@pytest.mark.parametrize("name", SAME_LINES)
def test_example_prints_the_jax_examples_lines(name):
    jax = subprocess.run(
        [sys.executable, f"examples/{name}.py"], cwd=REPO,
        env=_env(XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                            + " --xla_force_host_platform_device_count=8")),
        capture_output=True, text=True, timeout=300)
    assert jax.returncode == 0, jax.stderr[-3000:]
    code = (f"from ompi_release_tpu_torch.examples import {name}\n"
            f"raise SystemExit({name}.main(device='cpu'))\n")
    port = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert port.returncode == 0, port.stderr[-3000:]
    assert _lines(port.stdout) == _lines(jax.stdout)
    assert "OK" in port.stdout or "complete" in port.stdout


def test_unified_world_example_under_tpurun():
    """2 processes x 4 virtual ranks: the collective, p2p and RMA cross
    the process boundary through the public API."""
    r = subprocess.run(
        [sys.executable, "-m", "ompi_release_tpu_torch.tools.tpurun",
         "-n", "2", sys.executable, "-c",
         "from ompi_release_tpu_torch.examples import unified_world_tpu "
         "as m; raise SystemExit(m.main(device='cpu'))"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:] + r.stdout[-3000:]
    assert "unified world OK (ranks 0..3 of 8)" in r.stdout
    assert "unified world OK (ranks 4..7 of 8)" in r.stdout
