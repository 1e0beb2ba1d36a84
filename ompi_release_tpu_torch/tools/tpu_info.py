"""tpu_info — the ``ompi_info`` analogue.

Dumps every framework, component, config variable (with value +
source), and performance variable, plus the torch device view (each
card's name, count and memory, or the host) — the
introspection contract of ``ompi/tools/ompi_info`` (SURVEY §5
observability: "dumps every framework/component/variable").

Usage:
    python -m ompi_release_tpu_torch.tools.tpu_info            # summary
    python -m ompi_release_tpu_torch.tools.tpu_info --all      # + all vars
    python -m ompi_release_tpu_torch.tools.tpu_info --param pml coll
    python -m ompi_release_tpu_torch.tools.tpu_info --json
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List


def _import_everything() -> None:
    """Import every subsystem so all frameworks/vars self-register
    (ompi_info opens every framework the same way)."""
    from .. import coll, comm, datatype, ops, runtime  # noqa: F401
    from ..btl import components as _b  # noqa: F401
    from ..coll import components as _c  # noqa: F401
    from ..ops import cuda_op as _co  # noqa: F401
    from ..p2p import pml as _p  # noqa: F401
    from ..io import sharded as _s  # noqa: F401
    from ..ft import sensor as _f  # noqa: F401
    from ..parallel import dp as _dp  # noqa: F401
    from ..runtime import ess as _e  # noqa: F401
    from ..runtime import mesh as _m

    _m.register_vars()
    _p.register_vars()
    _s.register_vars()
    _f.register_vars()
    from ..parallel.dp import register_vars as _dpr

    _dpr()


def devices() -> List[Dict[str, Any]]:
    """The torch device view: every CUDA card (name, memory), or the
    host when there is none."""
    import torch

    if not torch.cuda.is_available():
        return [{"id": 0, "platform": "cpu", "kind": "cpu",
                 "process": 0, "memory_bytes": None}]
    out = []
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        out.append({"id": i, "platform": "gpu", "kind": str(props.name),
                    "process": 0,
                    "memory_bytes": int(props.total_memory)})
    return out


def gather(include_vars: bool = True) -> Dict[str, Any]:
    from ..mca import pvar as pvar_mod
    from ..mca import var as var_mod
    from ..mca.component import FRAMEWORKS

    _import_everything()

    info: Dict[str, Any] = {
        "package": "ompi_release_tpu_torch",
        "devices": devices(),
        "frameworks": [
            {
                "name": fw.name,
                "description": fw.description,
                "components": [
                    {"name": c.NAME, "priority": c.priority}
                    for c in fw.components()
                ],
            }
            for fw in FRAMEWORKS.all()
        ],
    }
    if include_vars:
        info["variables"] = var_mod.VARS.describe_all()
        info["pvars"] = pvar_mod.PVARS.read_all()
    return info


def render_text(info: Dict[str, Any], show_vars: bool) -> str:
    lines: List[str] = []
    lines.append(f"Package: {info['package']}")
    lines.append("Devices:")
    for d in info["devices"]:
        mem = d.get("memory_bytes")
        lines.append(
            f"  [{d['id']}] {d['platform']}/{d['kind']} "
            f"(process {d['process']})"
            + (f" {mem / 2**30:.1f} GiB" if mem else "")
        )
    lines.append("Frameworks:")
    for fw in info["frameworks"]:
        comps = ", ".join(
            f"{c['name']}(prio={c['priority']})" for c in fw["components"]
        ) or "(none registered)"
        lines.append(f"  {fw['name']:<12} {comps}")
        if fw["description"]:
            lines.append(f"    {fw['description']}")
    if show_vars and "variables" in info:
        lines.append("Config variables (MCA):")
        for v in info["variables"]:
            lines.append(
                f"  {v['name']:<36} {v['type']:<6} "
                f"value={v['value']!r} source={v['source']}"
            )
            if v.get("help"):
                lines.append(f"    {v['help']}")
        lines.append("Performance variables:")
        for name, val in sorted(info.get("pvars", {}).items()):
            lines.append(f"  {name:<36} {val}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpu_info")
    ap.add_argument("--all", "-a", action="store_true",
                    help="show all config + perf variables")
    ap.add_argument("--param", nargs="*", default=None,
                    help="show variables whose name contains any prefix")
    ap.add_argument("--json", action="store_true", help="JSON output")
    args = ap.parse_args(argv)

    show_vars = bool(args.all or args.param)
    info = gather(include_vars=True)
    if args.param:
        info["variables"] = [
            v for v in info["variables"]
            if any(p in v["name"] for p in args.param)
        ]
        info["pvars"] = {
            k: v for k, v in info["pvars"].items()
            if any(p in k for p in args.param)
        }
    if args.json:
        print(json.dumps(info, indent=2, default=str))
    else:
        print(render_text(info, show_vars))
    return 0


if __name__ == "__main__":
    sys.exit(main())
