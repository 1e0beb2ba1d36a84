"""One run of one benchmark cell: set-up, the measured window, the
metrics and the correctness check.

Everything a cell needs is found by name from ``BENCHMARK.json``: its
configuration file, its traffic mix (``traffic/<name>.json``, turned
into work by ``generator.py``), the reference of its collective
(``reference/<collective>.py``) or of its model
(``reference/<configuration>.py``) and the readers of its per-layer
metrics (``metrics/<name>.py``). The program under test is
``ompi_release_tpu_torch``: WORLD comes up through its public ``init``
with the configuration's MCA settings, and the window drives the
communicator's collectives (or its fusion buffer) exactly as an
application does. A cell whose mix is a train step runs the
configuration's model instead (``trainstep.py``).
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: modules that must not be loaded in the process that prints a result,
#: compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "ompi_release_tpu")

#: the largest exact-sum gap a correct output may have: the mixes draw
#: integers whose 8-way float32 sums are exact in any order
GAP_LIMIT = 0.0


class RunError(Exception):
    """A run that must exit non-zero without printing a result."""


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def find_cell(bench: dict, name: str):
    """(cell, config file contents, traffic contents) of workload ``name``."""
    import generator

    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(ROOT / cfg_entry["file"]) as f:
        config = json.load(f)
    return cell, config, generator.load_json("traffic", cell["traffic"])


def metrics_of(bench: dict, cell: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` entries cell ``cell`` reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def make_inputs(traffic, device, seed: int):
    """Each unit's input variants, drawn on the device from the seed:
    one ``randint`` call a variant, integers below ``VALUE_BOUND`` in
    magnitude as float32, each tensor a contiguous slice of the call's
    buffer."""
    import generator
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed % 2**63)
    dtype = getattr(torch, traffic.dtype)
    b = generator.VALUE_BOUND
    inputs = []
    for unit in traffic.units:
        variants = []
        total = sum(math.prod(s) for s in unit.shapes)
        for _ in range(generator.VARIANTS):
            flat = torch.randint(-b, b, (total,), generator=g, device=device,
                                 dtype=dtype)
            views, off = [], 0
            for s in unit.shapes:
                n = math.prod(s)
                views.append(flat[off:off + n].view(s))
                off += n
            variants.append(views)
        inputs.append(variants)
    return inputs


def program_for(world, collective: str) -> Callable:
    """The program's call for one unit: its inputs -> its outputs."""
    from ompi_release_tpu_torch import ops

    if collective == "fused_allreduce":
        fb = world.fusion_buffer()

        def step(xs):
            handles = [fb.allreduce(g, ops.SUM) for g in xs]
            fb.flush()
            return [h.result() for h in handles]

        return step
    call = getattr(world, collective)
    return lambda xs: [call(x) for x in xs]


def _pvar_snapshot() -> Dict[str, object]:
    from ompi_release_tpu_torch.mca import pvar

    return pvar.PVARS.read_all()


def _pvar_delta(before: dict, after: dict) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for k, v in after.items():
        b = before.get(k)
        if isinstance(v, dict):
            b = b if isinstance(b, dict) else {}
            out[k] = {f: v.get(f, 0) - b.get(f, 0) for f in ("sum", "count")
                      if isinstance(v.get(f), (int, float))}
        elif isinstance(v, (int, float)):
            out[k] = v - (b if isinstance(b, (int, float)) else 0)
    return out


def power_limit(device) -> str:
    if device.type != "cuda":
        return "not measured"
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "not measured"
    return res.stdout.strip() if res.returncode == 0 else "not measured"


def _quantile(values: List[float], q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    s = sorted(values)
    pos = (len(s) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def end_to_end(name: str, run: dict) -> Optional[float]:
    """The harness's own end-to-end readings (host clock and the
    allocator's peak). A suffix after the first dot names the cells a
    split metric is kept apart for; it reads the same. ``mfu`` reads
    None where the card has no published peak (the CPU)."""
    name = name.split(".")[0]
    if name == "busbw_GBps":
        return run["bus_bytes"] / run["window_s"] / 1e9
    if name == "latency_us_p50":
        return statistics.median(run["latencies"]) * 1e6
    if name == "latency_us_p95":
        return _quantile(run["latencies"], 95) * 1e6
    if name == "peak_mem_GiB":
        return run["memory_peak_bytes"] / 2**30
    if name == "setup_s":
        return run["setup_s"]
    if name == "tokens_per_s":
        return run["tokens"] / sum(run["latencies"])
    if name == "mfu":
        if not run["peak_flops"]:
            return None
        return (100.0 * run["model_flops"] / sum(run["latencies"])
                / run["peak_flops"])
    raise RunError(f"no reading for end-to-end metric {name!r}")


def open_device(cell: dict, device: str):
    """The device a run uses: ``cuda:0`` when the cell's cards are
    present (RunError when they are not), else the CPU of the tests."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: this benchmark runs on the card "
                           "only")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise RunError(f"{cell['name']} needs {cell['chips']} cards, "
                           f"{torch.cuda.device_count()} present")
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    return dev


def init_world(config: dict, dev, ranks: int):
    """(the port's package, WORLD) brought up through its public
    ``init`` with the configuration's MCA settings; RunError unless
    WORLD has ``ranks`` ranks."""
    import ompi_release_tpu_torch as mpi

    cli = []
    for k, v in config.get("mca", {}).items():
        cli += ["--mca", k, str(v)]
    world = mpi.init(cli_args=cli, device=None if dev.type == "cuda"
                     else "cpu")
    if world.size != ranks:
        raise RunError(f"WORLD has {world.size} ranks, the configuration "
                       f"{ranks}")
    return mpi, world


def device_info(dev, cell: dict, peak: int) -> dict:
    """The result line's ``device``: platform, the card's name, the
    cards the cell uses and the allocator's peak."""
    import torch

    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return {"platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": name, "count": int(cell["chips"]),
            "memory_peak_bytes": int(peak)}


def end_to_end_metrics(bench: dict, workload: str, readings: dict,
                       dev) -> Dict[str, dict]:
    """The cell's end-to-end metrics from the run's readings. A reading
    the card gives none of is a RunError; on the CPU it is left out."""
    out = {}
    for m in metrics_of(bench, workload, "end_to_end"):
        value = end_to_end(m["name"], readings)
        if value is None:
            if dev.type == "cuda":
                raise RunError(f"no reading of {m['name']} on this card")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def per_layer_metrics(bench: dict, workload: str, ctx: dict
                      ) -> Dict[str, dict]:
    """The cell's per-layer metrics that their readers found something
    to read for in ``ctx``."""
    import metrics as readers

    out = {}
    for m in metrics_of(bench, workload, "per_layer"):
        value = readers.load(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device: str = "cuda",
        overrides: Optional[Dict[str, dict]] = None,
        program: Optional[Callable] = None) -> dict:
    """One run of cell ``workload``; returns the result line's object.

    ``device="cpu"``, ``overrides`` (keys ``config`` and ``traffic``,
    merged over the files) and ``program`` (a function of the world and
    the collective's name, or for a train step of the world and the
    ``trainstep.Model``, that returns the call to time in place of the
    port's) are for the tests and the control; the command line never
    sets them."""
    import devtrace
    import generator
    import reference
    import torch
    from torch import profiler

    bench = load_benchmark()
    cell, config, mix = find_cell(bench, workload)
    for key, extra in (overrides or {}).items():
        {"config": config, "traffic": mix}[key].update(extra)
    dev = open_device(cell, device)
    traffic = generator.build(mix, config, seed)
    if isinstance(traffic, generator.StepTraffic):
        import trainstep

        return trainstep.run(bench, cell, config, traffic, seed, seconds,
                             trace, t_start=t_start, dev=dev,
                             program=program)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    mpi, world = init_world(config, dev, traffic.ranks)
    ref = reference.for_collective(traffic.collective)
    call = (program or program_for)(world, traffic.collective)
    t_init = time.perf_counter()
    inputs = make_inputs(traffic, dev, seed)
    sync()
    t_inputs = time.perf_counter()

    # warm-up: every unit's signature interpreted once, then captured
    # and replayed, then replayed once more
    for variants in inputs:
        for k in range(3):
            outs = call(variants[k % len(variants)])
            sync()
            del outs
    if dev.type == "cuda":
        # the kept outputs outlive their calls, so each would make the
        # allocator call cudaMalloc inside the window: cache blocks for
        # them and for the live call's outputs now (outputs have the
        # inputs' shapes)
        held = [torch.empty(s, dtype=getattr(torch, traffic.dtype),
                            device=dev)
                for unit in traffic.units
                for _ in range(traffic.sample_len + 1) for s in unit.shapes]
        del held
    setup_s = time.perf_counter() - t_start
    print(f"setup: {t_init - t_start:.3f} s to WORLD, inputs "
          f"{t_inputs - t_init:.3f} s, warm-up "
          f"{t_start + setup_s - t_inputs:.3f} s", file=sys.stderr)

    def span(name):
        return (profiler.record_function(name) if trace
                else contextlib.nullcontext())

    occurrences = [0] * len(traffic.units)
    kept = []  # (unit, variant, outputs)
    latencies: List[float] = []
    bus_bytes = least_bytes = 0.0
    factor = ref.bus_factor(traffic.ranks)
    blocks = 0
    with contextlib.ExitStack() as stack:
        if trace:
            acts = [profiler.ProfilerActivity.CPU] + (
                [profiler.ProfilerActivity.CUDA] if dev.type == "cuda"
                else [])
            prof = stack.enter_context(profiler.profile(activities=acts))
            stack.enter_context(span(devtrace.WINDOW_SPAN))
        before = _pvar_snapshot()
        t_first = t_last = time.perf_counter()
        while True:
            for u in traffic.block(blocks):
                occ = occurrences[u]
                v = occ % generator.VARIANTS
                t0 = time.perf_counter()
                with span("bench.dispatch"):
                    outs = call(inputs[u][v])
                with span("bench.sync"):
                    sync()
                t_last = time.perf_counter()
                latencies.append(t_last - t0)
                nbytes = traffic.units[u].bytes_per_rank
                bus_bytes += factor * nbytes
                least_bytes += 2.0 * traffic.ranks * nbytes
                if traffic.kept(u, occ):
                    kept.append((u, v, outs))
                del outs
                occurrences[u] = occ + 1
            blocks += 1
            if trace:
                if blocks >= traffic.trace_blocks:
                    break
            elif (t_last - t_first >= seconds
                  and blocks >= traffic.min_blocks()):
                break
        after = _pvar_snapshot()
    window_s = t_last - t_first
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    found = forbidden_modules()
    if found:
        raise RunError("loaded in the measuring process: " + ", ".join(found))

    readings = {"bus_bytes": bus_bytes, "window_s": window_s,
                "latencies": latencies, "memory_peak_bytes": peak,
                "setup_s": setup_s}
    info = device_info(dev, cell, peak)
    result = {"correct": False, "attempted": len(latencies), "failed": 0,
              "metrics": {}, "device": info}
    if trace:
        import peaks

        summary = devtrace.reduce(*devtrace.events_of(prof))
        ctx = {"pvars": _pvar_delta(before, after), "ops": summary["ops"],
               "busy_s": summary["busy_s"], "window_s": summary["window_s"],
               "steps": len(latencies), "least_bytes": least_bytes,
               "hbm_bytes_per_s": peaks.hbm_bytes_per_s(info["kind"])}
        result["metrics"] = per_layer_metrics(bench, workload, ctx)
        info["busy_s"] = summary["busy_s"]
        info["window_s"] = summary["window_s"]
        result["breakdown"] = summary["breakdown"]
        del prof
    else:
        result["metrics"] = end_to_end_metrics(bench, workload, readings,
                                               dev)
    info["power_limit"] = power_limit(dev)

    # the correctness check, once the window has closed, the peak is
    # read and the program's state is freed: every kept output against
    # the reference, worked out again from the inputs the harness made
    del call, world
    mpi.finalize()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    gap, failed = 0.0, 0
    for u, v, outs in kept:
        g = max(ref.max_gap(x, o) for x, o in zip(inputs[u][v], outs))
        if not g <= GAP_LIMIT:
            failed += 1
        gap = max(gap, g)
    want = len(traffic.units) * traffic.sample_len
    result["failed"] = failed
    result["correct"] = failed == 0 and len(kept) >= want
    result["checks"] = {
        "max_abs_gap": {"value": gap if math.isfinite(gap) else 1e300,
                        "limit": GAP_LIMIT},
        "outputs_compared": {"value": len(kept), "limit": want},
    }
    return result


def report(result: dict) -> None:
    """The checks as the last lines on standard error, then the result
    as the last line on standard output."""
    print(f"correct = {result['correct']}", file=sys.stderr)
    for k, c in result["checks"].items():
        rel = "at least" if k == "outputs_compared" else "at most"
        print(f"check {k} = {c['value']!r} ({rel} {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
