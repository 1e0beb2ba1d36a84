"""tpu-checkpoint — the ``orte-checkpoint``/``orte-restart`` tool role.

The reference ships operator CLIs over its checkpoint stack
(``orte/tools/orte-checkpoint``, ``orte-restart``; storage under
``orte/mca/sstore``). This is the same operator surface over
``ft/checkpoint.py``'s sharded snapshots:

    python -m ompi_release_tpu_torch.tools.tpu_checkpoint list DIR
    python -m ompi_release_tpu_torch.tools.tpu_checkpoint show DIR [--step N]
    python -m ompi_release_tpu_torch.tools.tpu_checkpoint verify DIR [--step N]
    python -m ompi_release_tpu_torch.tools.tpu_checkpoint gc DIR --keep K

``verify`` re-reads every shard of a committed step (the sharded
loader validates the per-shard CRCs), catching bit-rot before a
restart depends on the snapshot. ``gc`` applies the sstore retention
policy by hand.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from typing import List, Optional


def _ckpt(directory: str):
    from ..ft.checkpoint import Checkpointer

    if not os.path.isdir(directory):
        raise SystemExit(f"tpu-checkpoint: no such directory: {directory}")
    return Checkpointer(directory)


def cmd_list(args) -> int:
    ck = _ckpt(args.directory)
    steps = ck.steps()
    if not steps:
        print("no committed checkpoints")
        return 1
    for s in steps:
        meta = ck.meta(s)
        d = os.path.join(args.directory, f"step_{s:010d}")
        nbytes = sum(
            os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
        )
        extras = {k: v for k, v in meta.items()
                  if k not in ("step", "time")}
        print(f"step {s:>8}  {nbytes / 1e6:9.2f} MB  "
              f"t={meta.get('time', 0):.0f}"
              + (f"  {extras}" if extras else ""))
    return 0


def cmd_show(args) -> int:
    ck = _ckpt(args.directory)
    step = args.step if args.step is not None else ck.latest_step()
    if step is None:
        print("no committed checkpoints")
        return 1
    print(json.dumps(ck.meta(step), indent=2))
    d = os.path.join(args.directory, f"step_{step:010d}")
    for name in sorted(os.listdir(d)):
        print(f"  {name}  {os.path.getsize(os.path.join(d, name))} B")
    return 0


def cmd_verify(args) -> int:
    """Re-read every shard of the step: the sharded loader's CRC
    validation runs on each — bit-rot surfaces here, not at restart."""
    from ..io import sharded

    ck = _ckpt(args.directory)
    step = args.step if args.step is not None else ck.latest_step()
    if step is None:
        print("no committed checkpoints")
        return 1
    d = os.path.join(args.directory, f"step_{step:010d}")
    manifest = os.path.join(d, "pytree.json")
    if not os.path.exists(manifest):
        print(f"step {step}: missing pytree manifest")
        return 1
    with open(manifest) as f:
        n_leaves = json.load(f)["num_leaves"]
    bad = 0
    for i in range(n_leaves):
        name = f"leaf{i:04d}"
        try:
            sharded.load_sharded(d, name=name)
        except Exception as e:
            print(f"step {step}: leaf '{name}' FAILED: {e}")
            bad += 1
    if bad:
        print(f"step {step}: {bad}/{n_leaves} leaves corrupt")
        return 1
    print(f"step {step}: {n_leaves} leaves verified OK")
    return 0


def cmd_gc(args) -> int:
    ck = _ckpt(args.directory)
    steps = ck.steps()
    doomed = steps[:-args.keep] if args.keep else steps
    for s in doomed:
        shutil.rmtree(os.path.join(args.directory, f"step_{s:010d}"),
                      ignore_errors=True)
        print(f"removed step {s}")
    print(f"kept {len(steps) - len(doomed)} of {len(steps)}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu-checkpoint",
        description="Inspect/verify/GC sharded checkpoints "
                    "(orte-checkpoint tool role)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn in (("list", cmd_list), ("show", cmd_show),
                     ("verify", cmd_verify), ("gc", cmd_gc)):
        p = sub.add_parser(name)
        p.add_argument("directory")
        if name in ("show", "verify"):
            p.add_argument("--step", type=int, default=None)
        if name == "gc":
            p.add_argument("--keep", type=int, required=True)
        p.set_defaults(fn=fn)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
