"""The train-step kind of cell: one unit is one optimizer step of a model
of the port's ``models`` package on a batch of token ids.

The configuration's ``model`` block names the module (``module``, one
of ``ompi_release_tpu_torch.models``), its ``ModelConfig`` keywords
(``config``, dtypes by name), the mesh (``mesh``, the axis sizes of
``parallel.build_parallel_mesh``) and the optimizer (``optimizer``,
``{"name": "adamw", "lr": ...}``). The harness builds the step with the
module's ``make_train_step`` and the port's ``optim.adamw``, the entry
points ``OneDeviceModel`` uses, and times each step from its dispatch
to the return of the device's synchronize.

The weights and the batches are the benchmark's: drawn on the device
from the seed, the batches first, then the weights by the cell's
reference (``reference/<configuration>.py``), which the program and
the reference are both handed. Set-up drives the one step object
through its first ``generator.STEP_BATCHES`` steps, through the
window's own call and feed and each on rows of its own, and hands the
same object to the window. Of those steps it keeps each loss, the first
gradient as the optimizer got it (Adam's first moment after one step,
over 1 - beta1) and the parameters' change after the last, as the norm
of each of the reference's units, and on the host the first gradient
and the change of one layer drawn from the seed and of the parameters
outside the layers: the change's direction is what a wrong update
turns.
Once the window has closed and the program's state is freed, the
reference works the same steps out again in float32 and the check
compares.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import math
import statistics
import sys
import time
from typing import Callable, Dict, List

import numpy as np

import generator
from harness import (RunError, _pvar_delta, _pvar_snapshot, device_info,
                     end_to_end_metrics, forbidden_modules, init_world,
                     per_layer_metrics, power_limit)

#: units whose reference gradient is under this share of the median
#: unit's take no part in the change: Adam moves them by round-off alone
STILL = 1e-3


@dataclasses.dataclass
class Model:
    """What a run builds from its configuration's ``model`` block."""

    module: object  # the ompi_release_tpu_torch.models module
    cfg: object  # its ModelConfig
    mesh: object  # parallel.ParallelMesh
    block: dict  # the configuration's model block
    reference: object  # reference/<configuration>.py


def build_model(config: dict, name: str, dev) -> Model:
    import torch

    import reference
    from ompi_release_tpu_torch import parallel

    block = config["model"]
    module = importlib.import_module(
        f"ompi_release_tpu_torch.models.{block['module']}")
    kwargs = {k: getattr(torch, v) if k == "dtype" or k.endswith("_dtype")
              else v for k, v in block["config"].items()}
    mesh = parallel.build_parallel_mesh(**block["mesh"], devices=[dev])
    return Model(module, module.ModelConfig(**kwargs), mesh, block,
                 reference.for_model(name))


def program_for(world, model: Model) -> Callable:
    """The port's train step: ``(params, opt_state, tokens, targets) ->
    loss``."""
    step = model.module.make_train_step(model.cfg, model.mesh)
    return lambda params, opt, tokens, targets: step(params, opt, tokens,
                                                     targets)[2]


def optimizer_of(block: dict):
    """The port's optimizer factory the configuration names."""
    from ompi_release_tpu_torch import optim

    spec = block["optimizer"]
    if spec["name"] != "adamw":
        raise RunError(f"optimizer {spec['name']!r}: the check reads "
                       "Adam's first moment, so only adamw")
    return optim.adamw(float(spec["lr"]))


def draw(model: Model, traffic, seed: int, dev):
    """(batches, params) from the seed: (STEP_BATCHES, B, S + 1) token
    ids below the configuration's vocabulary, then the weights."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed % 2**63)
    batches = torch.randint(
        0, traffic.vocab,
        (generator.STEP_BATCHES, traffic.batch, traffic.seq + 1),
        generator=g, device=dev)
    return batches, model.reference.init_params(model.block, g, dev)


def feeds_of(batches) -> List[tuple]:
    """(tokens, targets) of each batch: the targets shifted by one."""
    return [(b[:, :-1].contiguous(), b[:, 1:].contiguous())
            for b in batches]


def tree_map(f, tree: Dict) -> Dict:
    return {k: tree_map(f, v) if isinstance(v, dict) else f(v)
            for k, v in tree.items()}


def leaves(tree: Dict) -> list:
    """The tensors of a nested dict, in sorted key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(leaves(v) if isinstance(v, dict) else [v])
    return out


def unit_norms(ref, tree: Dict, scale: float = 1.0) -> Dict[str, float]:
    return {n: float(t.detach().float().norm()) * scale
            for n, (_, t) in ref.units(tree).items()}


def kept_units(ref, tree: Dict, layer: int, scale: float = 1.0):
    """The units of ``layer`` and those outside the layers, as float32
    copies on the host."""
    return {n: t.detach().float().cpu() * scale
            for n, (lay, t) in ref.units(tree).items()
            if lay is None or lay == layer}


def changes(ref, params: Dict, p0: Dict, layer: int):
    """The norm of each unit's change from ``p0``, and the change of the
    units of ``layer`` and of those outside the layers on the host."""
    norms, kept = {}, {}
    for (n, (lay, t)), (_, t0) in zip(ref.units(params).items(),
                                      ref.units(p0).values()):
        d = t.detach().float() - t0.float()
        norms[n] = float(d.norm())
        if lay is None or lay == layer:
            kept[n] = d.cpu()
    return norms, kept


def direction_gap(prog, want) -> float:
    """1 - the cosine between the program's change of a unit and the
    reference's: 0 along it, 2 against it, 1 where either is nought."""
    na, nb = float(prog.norm()), float(want.norm())
    if na == 0 or nb == 0:
        return 1.0
    return 1.0 - float((prog.double() * want.double()).sum()) / (na * nb)


def norm_gaps(prog: Dict[str, float], ref: Dict[str, float],
              names) -> Dict[str, float]:
    """Each unit's |program norm - reference norm|, against the
    reference's norm of that unit or of the median unit, whichever is
    larger."""
    names = list(names)
    med = statistics.median(ref[n] for n in names)
    out = {}
    for n in names:
        base = max(ref[n], med)
        gap = abs(prog[n] - ref[n])
        out[n] = gap / base if base else (0.0 if gap == 0 else math.inf)
    return out


def worst(gaps: Dict[str, float], k: int = 3) -> str:
    return ", ".join(f"{n} {g:.3g}" for n, g in
                     sorted(gaps.items(), key=lambda kv: -kv[1])[:k])


def follow(model: Model, traffic, seed: int, dev, layer: int, dtype=None
           ) -> dict:
    """The reference's first STEP_BATCHES steps from the seed in
    float32: each loss, the norms of the first gradient's units, the
    first gradient's kept units, the norms of the change's units and
    the change's kept units."""
    import torch

    import reference.adamw as adamw

    ref = model.reference
    batches, p0 = draw(model, traffic, seed, dev)
    params = tree_map(lambda t: t.float(), p0)
    del p0
    opt = adamw.AdamW(leaves(params), model.block["optimizer"]["lr"])
    out = {"losses": []}
    for k, (tokens, targets) in enumerate(feeds_of(batches)):
        loss, grads = ref.loss_and_grads(model.block, params, tokens,
                                         targets, dtype)
        out["losses"].append(float(loss))
        if k == 0:
            out["grad_norms"] = unit_norms(ref, grads)
            out["grads"] = kept_units(ref, grads, layer)
        opt.step(leaves(grads))
        del grads
    out["change_norms"], out["change"] = changes(
        ref, params, draw(model, traffic, seed, dev)[1], layer)
    del params, opt
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def run(bench: dict, cell: dict, config: dict, traffic, seed: int,
        seconds: float, trace: bool, *, t_start: float, dev,
        program=None) -> dict:
    """One run of a train-step cell; returns the result line's object
    (``harness.run`` hands it the cell, its files and the device)."""
    import devtrace
    import peaks
    import torch
    from torch import profiler

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    workload = cell["name"]
    mpi, world = init_world(config, dev, traffic.ranks)
    model = build_model(config, cell["config"], dev)
    if model.mesh.size != traffic.ranks:
        raise RunError(f"the mesh has {model.mesh.size} ranks, WORLD "
                       f"{traffic.ranks}")
    ref = model.reference
    t_init = time.perf_counter()
    batches, params = draw(model, traffic, seed, dev)
    feeds = feeds_of(batches)
    opt = optimizer_of(model.block)(params)
    step = (program or program_for)(world, model)
    sync()
    t_inputs = time.perf_counter()

    def one(k):
        """The window's call and feed: step ``k`` on its batch."""
        tokens, targets = feeds[k % len(feeds)]
        return step(params, opt, tokens, targets)

    # set-up: the first steps, which the check follows, warm every
    # shape up; of each the loss, after the first the gradient as the
    # optimizer got it, after the last the change
    layer = int(np.random.default_rng([seed % 2**63, 2**32 + 11]).integers(
        0, 1 + max(lay for lay, _ in ref.units(params).values()
                   if lay is not None)))
    beta1 = opt.param_groups[0]["betas"][0]
    prog = {"losses": []}
    for k in range(generator.STEP_BATCHES):
        loss = one(k)
        sync()
        prog["losses"].append(float(loss))
        if k == 0:
            # a step that never reached the optimizer left it no moment
            moment = tree_map(lambda p: opt.state[p]["exp_avg"]
                              if "exp_avg" in opt.state.get(p, {})
                              else torch.zeros_like(p), params)
            prog["grad_norms"] = unit_norms(ref, moment, 1 / (1 - beta1))
            prog["grads"] = kept_units(ref, moment, layer, 1 / (1 - beta1))
            del moment
    prog["change_norms"], prog["change"] = changes(
        ref, params, draw(model, traffic, seed, dev)[1], layer)
    sync()
    setup_s = time.perf_counter() - t_start
    print(f"setup: {t_init - t_start:.3f} s to WORLD and the model, inputs "
          f"{t_inputs - t_init:.3f} s, the first {generator.STEP_BATCHES} "
          f"steps {t_start + setup_s - t_inputs:.3f} s", file=sys.stderr)

    def span(name):
        return (profiler.record_function(name) if trace
                else contextlib.nullcontext())

    latencies: List[float] = []
    losses = []
    with contextlib.ExitStack() as stack:
        if trace:
            acts = [profiler.ProfilerActivity.CPU] + (
                [profiler.ProfilerActivity.CUDA] if dev.type == "cuda"
                else [])
            prof = stack.enter_context(profiler.profile(activities=acts))
            stack.enter_context(span(devtrace.WINDOW_SPAN))
        before = _pvar_snapshot()
        t_first = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            with span("bench.dispatch"):
                loss = one(generator.STEP_BATCHES + len(latencies))
            with span("bench.sync"):
                sync()
            t_last = time.perf_counter()
            latencies.append(t_last - t0)
            losses.append(loss)
            if trace:
                if len(latencies) >= traffic.trace_blocks:
                    break
            elif t_last - t_first >= seconds:
                break
        after = _pvar_snapshot()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    found = forbidden_modules()
    if found:
        raise RunError("loaded in the measuring process: " + ", ".join(found))

    n = len(latencies)
    flops = ref.step_flops(model.block, traffic.batch, traffic.seq)
    info = device_info(dev, cell, peak)
    readings = {"latencies": latencies, "tokens": n * traffic.tokens,
                "model_flops": n * flops, "memory_peak_bytes": peak,
                "setup_s": setup_s,
                "peak_flops": peaks.flops_per_s(
                    info["kind"], model.block["config"]["dtype"])}
    result = {"correct": False, "attempted": n, "failed": 0, "metrics": {},
              "device": info}
    if trace:
        summary = devtrace.reduce(*devtrace.events_of(prof))
        ctx = {"pvars": _pvar_delta(before, after), "ops": summary["ops"],
               "busy_s": summary["busy_s"], "window_s": summary["window_s"],
               "steps": n, "least_bytes": 0.0,
               "hbm_bytes_per_s": peaks.hbm_bytes_per_s(info["kind"]),
               "tokens": readings["tokens"],
               "model_flops": readings["model_flops"],
               "peak_flops": readings["peak_flops"]}
        result["metrics"] = per_layer_metrics(bench, workload, ctx)
        info["busy_s"] = summary["busy_s"]
        info["window_s"] = summary["window_s"]
        result["breakdown"] = summary["breakdown"]
        del prof
    else:
        result["metrics"] = end_to_end_metrics(bench, workload, readings,
                                               dev)
    info["power_limit"] = power_limit(dev)

    # the check, once the window has closed, the peak is read and the
    # program's state is freed: the reference follows the first steps
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    del step, opt, params, feeds, batches, losses, world
    mpi.finalize()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    want = follow(model, traffic, seed, dev, layer)
    grad_units = list(want["grad_norms"])
    med = statistics.median(want["grad_norms"].values())
    moving = [u for u in grad_units if want["grad_norms"][u] >= STILL * med]
    grad_gaps = norm_gaps(prog["grad_norms"], want["grad_norms"],
                          grad_units)
    change_gaps = norm_gaps(prog["change_norms"], want["change_norms"],
                            moving)
    rel_gaps = {u: float((prog["grads"][u] - g).norm() / g.norm())
                for u, g in want["grads"].items()}
    dir_gaps = {u: direction_gap(prog["change"][u], d)
                for u, d in want["change"].items() if u in moving}
    loss_gaps = [abs(p - r) / abs(r)
                 for p, r in zip(prog["losses"], want["losses"])]
    readings = {
        "loss1_rel_gap": loss_gaps[0],
        "loss_rel_gap": max(loss_gaps),
        "grad_norm_gap": max(grad_gaps.values()),
        "change_norm_gap": max(change_gaps.values()),
        "grad_rel_gap": max(rel_gaps.values()),
        "change_dir_gap": max(dir_gaps.values()),
    }
    print(f"check: {len(grad_units)} units, {len(grad_units) - len(moving)}"
          f" left out of the change (reference gradient under {STILL} of "
          f"the median unit's); layer {layer} kept; losses "
          f"{prog['losses']} against {want['losses']}; worst units: "
          f"gradient norms {worst(grad_gaps)}; change norms "
          f"{worst(change_gaps)}; gradients {worst(rel_gaps)}; change "
          f"directions {worst(dir_gaps)}",
          file=sys.stderr)
    checks = {}
    for name, value in readings.items():
        if name in ref.LIMITS:
            checks[name] = {"value": value if math.isfinite(value)
                            else 1e300, "limit": ref.LIMITS[name][0]}
        else:
            print(f"not compared: {name} = {value!r}", file=sys.stderr)
    checks["outputs_compared"] = {"value": len(want["losses"]),
                                  "limit": generator.STEP_BATCHES}
    result["failed"] = failed
    result["correct"] = failed == 0 and all(
        c["value"] <= c["limit"] for k, c in checks.items()
        if k != "outputs_compared") and (
        len(want["losses"]) >= generator.STEP_BATCHES)
    result["checks"] = checks
    return result
