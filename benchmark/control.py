"""The control of the correctness check: the reference put in the
program's place and computed in the precision below the one the
configuration states: bfloat16 for the collectives' float32, and for a
train step the cell reference's ``CONTROL`` (fp8 for bfloat16, every
product's operands rounded to it). Every seed must come out not
correct; the smallest reading of a number it fails is that number's
upper reading.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 \\
        [--seconds 1]

Prints one JSON line a seed. Needs a card, as ``run.py`` does; the
tests run the same control on the CPU at a tiny size
(``tests/test_harness_control.py``, ``tests/test_harness_step.py``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def control_step(world, model):
    """The model's reference in the place of the port's train step:
    its loss and gradient in the reference's ``CONTROL`` precision, the
    one below the model's, then the run's optimizer step."""
    import torch

    import trainstep

    low = getattr(torch, model.reference.CONTROL)

    def step(params, opt, tokens, targets):
        opt.zero_grad(set_to_none=True)
        f32 = trainstep.tree_map(lambda p: p.detach().float(), params)
        loss, grads = model.reference.loss_and_grads(
            model.block, f32, tokens, targets, low)
        for p, g in zip(trainstep.leaves(params), trainstep.leaves(grads)):
            p.grad = g.to(p.dtype)
        opt.step()
        return torch.tensor(loss)

    return step


def control_program(world, collective):
    """The reference in bfloat16, in the place of ``world``'s call."""
    import torch

    import reference

    ref = reference.for_collective(collective)
    return lambda xs: [ref.compute(x, torch.bfloat16).to(x.dtype)
                       for x in xs]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    for path in (str(ROOT), str(HERE)):
        if path not in sys.path:
            sys.path.insert(0, path)
    import harness
    from ompi_release_tpu_torch.runtime import runtime

    _, _, mix = harness.find_cell(harness.load_benchmark(), args.workload)
    program = control_step if "step" in mix else control_program
    t_start = T_START
    for seed in args.seeds:
        result = harness.run(args.workload, seed, args.seconds, False,
                             t_start=t_start, program=program)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": result["correct"],
                          "failed": result["failed"],
                          "attempted": result["attempted"],
                          "checks": result["checks"]}), flush=True)
        runtime._reset_for_tests()  # the next seed brings WORLD up anew
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
