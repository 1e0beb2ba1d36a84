"""Plain PyTorch references of the collectives and the models the
benchmark drives.

One module a collective, found by the traffic mix's ``collective``
name. Each gives ``bus_factor(n)`` (nccl-tests' bus-bandwidth factor),
``compute(x, dtype)`` (the result for a rank-stacked input, computed in
``dtype``: the control puts it in the program's place in a lower
precision) and ``max_gap(x, out)`` (the largest absolute difference
between a program output and the exact result, in float64, worked out
in blocks so that it fits beside the program's buffers). Nothing here
imports the program under test.

One module a model configuration, found by the configuration's name,
for cells whose mix is a train step (``trainstep.py``). It computes in
float32 with TF32 off, and gives:

- ``LIMITS``: each number the check compares, as ``{name: (limit,
  reason)}``;
- ``CONTROL``: the name of the torch dtype below the model's, which the
  control rounds every product's operands to;
- ``init_params(model, generator, device)``: the weights, drawn from the
  generator on the device, in the layout and the dtypes the program's
  ``make_train_step`` takes (``model`` is the configuration's ``model``
  block; both sides are handed the same);
- ``units(tree)``: ``{name: (layer or None, tensor)}``, the pieces of a
  parameter-shaped tree that the check compares one by one;
- ``loss_and_grads(model, params, tokens, targets, dtype=None)``: the
  mean loss of a batch and its gradient tree for float32 parameters,
  worked out in blocks of rows; ``dtype`` rounds every product's
  operands to a lower precision (the control);
- ``step_flops(model, batch, seq)``: the step's model FLOPs in closed
  form from the published widths.

``adamw`` is the optimizer the model references share.
"""

import importlib


def for_collective(name: str):
    """The reference module of collective ``name``."""
    return importlib.import_module(f"{__name__}.{name}")


def for_model(name: str):
    """The reference module of model configuration ``name``."""
    return importlib.import_module(f"{__name__}.{name}")


#: elements a block of the float64 comparison handles
BLOCK = 1 << 24


def worst(diff) -> float:
    """The largest |diff|; a NaN counts as an infinite gap."""
    return float(diff.abs().nan_to_num(nan=float("inf")).max())
