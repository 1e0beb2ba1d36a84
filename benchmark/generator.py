"""The one traffic generator: turns a traffic mix (``traffic/<name>.json``)
and a configuration (``configs/<name>.json``) into the work of a run.

A mix of the collective kind names a communicator collective and
either a list of per-rank sizes (one call a size) or a key of the
configuration that lists tensor shapes (one step = every tensor of the
list, in reverse order, as a backward pass yields gradients). Work is
issued in blocks: a block holds every unit once, in an order drawn from
the seed, so every seed runs the same multiset of sizes and only their
order differs. Each unit has ``VARIANTS`` inputs, used in turn, so
consecutive calls of one signature see different data. Which outputs
are kept for the correctness check is drawn from the seed too: for
every unit, ``sample_per_size`` consecutive occurrences starting at one
of the first ``sample_start_span`` (4 unless the mix says otherwise).

A mix of the train-step kind (``{"step": "train", "batch": B, "seq":
S}``) makes one unit one optimizer step of the configuration's model on
a (B, S) batch of packed token sequences, the targets the tokens
shifted by one. ``STEP_BATCHES`` batches are drawn and used in turn, so
the first steps, which the check follows, all see different rows.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parent

#: inputs a unit: two, so a result left over from the call before
#: cannot pass for the next one
VARIANTS = 2
#: inputs are integers in (-VALUE_BOUND, VALUE_BOUND): every 8-way
#: float32 sum of them is exact in any order
VALUE_BOUND = 2**20
#: distinct token batches of a train-step mix, used in turn: the check
#: follows the first ``STEP_BATCHES`` steps, each on rows of its own
STEP_BATCHES = 3


@dataclass
class Unit:
    """One call (a size) or one step (a tensor list) of the mix."""

    shapes: List[Tuple[int, ...]]  # rank-stacked: leading axis = ranks
    bytes_per_rank: int


@dataclass
class Traffic:
    collective: str
    ranks: int
    dtype: str
    units: List[Unit]
    trace_blocks: int
    seed: int
    sample_start: Dict[int, int] = field(default_factory=dict)
    sample_len: int = 1
    sample_span: int = 4

    def block(self, index: int) -> List[int]:
        """The unit ids of block ``index``, in the seed's order."""
        rng = np.random.default_rng([self.seed % 2**63, index])
        return [int(u) for u in rng.permutation(len(self.units))]

    def kept(self, unit: int, occurrence: int) -> bool:
        start = self.sample_start[unit]
        return start <= occurrence < start + self.sample_len

    def min_blocks(self) -> int:
        """Blocks a window needs before every kept sample is due."""
        return self.sample_span + self.sample_len


@dataclass
class StepTraffic:
    """A train-step mix: every unit is one optimizer step on a (batch,
    seq) batch of token ids below ``vocab``."""

    step: str
    batch: int
    seq: int
    vocab: int
    ranks: int  # the mesh's ranks, which WORLD must match
    trace_blocks: int
    seed: int

    @property
    def tokens(self) -> int:
        return self.batch * self.seq


def load_json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def build(traffic: dict, config: dict, seed: int) -> Traffic:
    """The run's work from a mix, a configuration and the seed."""
    if "step" in traffic:
        model = config["model"]
        return StepTraffic(
            step=traffic["step"], batch=int(traffic["batch"]),
            seq=int(traffic["seq"]), vocab=int(model["config"]["vocab"]),
            ranks=math.prod(int(n) for n in model["mesh"].values()),
            trace_blocks=int(traffic["trace_blocks"]), seed=int(seed))
    ranks = int(config.get("ranks", config.get("workers")))
    dtype = config["dtype"]
    itemsize = {"float32": 4}[dtype]
    units: List[Unit] = []
    if "sizes_bytes_per_rank" in traffic:
        for nbytes in traffic["sizes_bytes_per_rank"]:
            count = int(nbytes) // itemsize
            units.append(Unit([(ranks, count)], count * itemsize))
    else:
        listed: Sequence = config[traffic["tensors"]]
        shapes = [tuple(int(d) for d in s) for _, s in reversed(listed)]
        total = sum(math.prod(s) for s in shapes) * itemsize
        units.append(Unit([(ranks,) + s for s in shapes], total))
    rng = np.random.default_rng([seed % 2**63, 2**32 + 7])
    t = Traffic(collective=traffic["collective"], ranks=ranks, dtype=dtype,
                units=units, trace_blocks=int(traffic["trace_blocks"]),
                seed=int(seed), sample_len=int(traffic.get("sample_per_size", 1)),
                sample_span=int(traffic.get("sample_start_span", 4)))
    t.sample_start = {i: int(rng.integers(0, t.sample_span))
                      for i in range(len(units))}
    t.trace_blocks = max(t.trace_blocks, t.min_blocks())
    return t
