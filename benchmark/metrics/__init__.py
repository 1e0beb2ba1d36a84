"""Per-layer metric readers, one file a metric, found by the metric's
name in BENCHMARK.json (``metrics/<name>.py``). Each defines
``read(ctx)``, which returns the metric's value or None when the run
gave it nothing to read; the harness then leaves the metric out.

``ctx`` keys: ``pvars`` (the program's MPI_T pvars, each a delta over
the traced window; an aggregate as ``{"sum", "count"}``), ``ops``
(device operations in the window: name -> (seconds, count)),
``busy_s`` and ``window_s`` (the device's busy time and the window's
length), ``steps`` (calls, or gradient syncs, the harness issued),
``least_bytes`` (the window's collectives' least HBM traffic: every
rank's input read once and output written once) and ``hbm_bytes_per_s``
(the card's published bandwidth, None on an unknown card). In a
train-step cell ``steps`` counts optimizer steps, ``least_bytes`` is 0,
and ``tokens`` and ``model_flops`` (the window's steps' tokens and
model FLOPs, ``reference/<configuration>.py``'s ``step_flops``) and
``peak_flops`` (the card's published dense peak in the model's dtype,
None on an unknown card) are there besides.
"""

import importlib.util
import re
from pathlib import Path

DIR = Path(__file__).resolve().parent

#: PyTorch's index, gather, concatenation and copy kernels and the
#: device-to-device copies (``Memcpy DtoD``, a graph's ``memcpy*``
#: nodes): the data movement of the port's rank-axis runner
#: (``coll/driver.py`` + ``coll/spmd.py``) and of a plan's input copy and
#: output clone
RUNNER_COPY = re.compile(r"index|gather|scatter|CatArray|memcpy|direct_copy",
                         re.IGNORECASE)


def load(name: str):
    """The reader module of metric ``name`` (names may hold dots)."""
    path = DIR / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def collectives(ctx):
    """Collectives the program issued in the window (``coll_invocations``)."""
    return ctx["pvars"].get("coll_invocations") or 0


def device_seconds(ctx, pattern) -> float:
    return sum(s for name, (s, _) in ctx["ops"].items()
               if pattern.search(name))
