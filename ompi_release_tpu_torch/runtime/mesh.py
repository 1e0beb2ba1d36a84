"""Rank mapping + modex — the ORTE wire-up analogue over torch devices.

Counterpart of ``ompi_release_tpu/runtime/mesh.py``. The "allocation"
is the device set the ESS discovered; "mapping" lays ranks onto a mesh
of those devices; the modex enumerates per-rank endpoint records. A
rank is one row of the rank-stacked buffers the collectives take.

Virtual ranks: the JAX package gets 8 ranks on one host from 8 virtual
CPU devices; here the ``runtime_virtual_ranks`` cvar maps N ranks onto
the first device (N > 0), so N ranks share one H100 or the CPU. 0 means
one rank per device.
"""

from __future__ import annotations

import dataclasses
import math
import socket
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..mca import var as mca_var
from ..utils import output

_log = output.stream("mesh")


@dataclasses.dataclass(frozen=True)
class Endpoint:
    """One participant's modex record (the business-card analogue)."""

    rank: int
    device_id: int
    process_index: int
    platform: str
    device_kind: str
    coords: Tuple[int, ...]
    slice_index: int = 0
    host: str = ""


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ranks laid out on devices: ``devices`` is an object array of
    torch devices (one entry per rank, several ranks may share one)."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.devices.shape)


def factorize_torus(n: int, ndims: int) -> Tuple[int, ...]:
    """Balanced factorization of ``n`` into ``ndims`` dims (MPI_Dims_create).

    Dims as close to each other as possible, sorted non-increasing.
    """
    if ndims <= 0:
        raise ValueError("ndims must be >= 1")
    dims = [1] * ndims
    factors: List[int] = []
    m = n
    p = 2
    while p * p <= m:
        while m % p == 0:
            factors.append(p)
            m //= p
        p += 1
    if m > 1:
        factors.append(m)
    for f in sorted(factors, reverse=True):
        dims[dims.index(min(dims))] *= f
    return tuple(sorted(dims, reverse=True))


def register_vars() -> None:
    mca_var.register(
        "rmaps_mesh_shape", "str", "",
        "Explicit mesh shape as comma list (e.g. '4,2'); empty = auto 1D",
    )
    mca_var.register(
        "rmaps_mesh_axes", "str", "world",
        "Comma list of mesh axis names matching rmaps_mesh_shape",
    )
    mca_var.register(
        "runtime_virtual_ranks", "int", 0,
        "Number of ranks mapped onto the first device (they share it); "
        "0 = one rank per device",
    )


def rank_devices(devices: Sequence[torch.device]) -> List[torch.device]:
    """One device per rank: ``runtime_virtual_ranks`` copies of the
    first device, or the device list itself."""
    nvirt = int(mca_var.get("runtime_virtual_ranks", 0))
    if nvirt < 0:
        raise ValueError(f"runtime_virtual_ranks must be >= 0, got {nvirt}")
    if nvirt > 0:
        return [devices[0]] * nvirt
    return list(devices)


def build_mesh(devices: Sequence[torch.device],
               shape: Optional[Sequence[int]] = None,
               axis_names: Optional[Sequence[str]] = None) -> Mesh:
    """Lay the ranks' devices out as a mesh: 1-D ``world`` by default,
    or the explicit ``rmaps_mesh_shape``."""
    devices = list(devices)
    n = len(devices)
    if shape is None:
        spec = (mca_var.get("rmaps_mesh_shape") or "").strip()
        if spec:
            shape = tuple(int(s) for s in spec.split(","))
    if shape is None:
        shape = (n,)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} ranks")
    if axis_names is None:
        spec = (mca_var.get("rmaps_mesh_axes") or "world").strip()
        names = [s.strip() for s in spec.split(",") if s.strip()]
        if len(names) != len(shape):
            names = (["world"] if len(shape) == 1
                     else [f"axis{i}" for i in range(len(shape))])
        axis_names = names
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    mesh = Mesh(arr.reshape(shape), tuple(axis_names))
    _log.verbose(1, f"built mesh shape={shape} axes={tuple(axis_names)} "
                    f"on {sorted({str(d) for d in devices})}")
    return mesh


def _device_kind(dev: torch.device) -> str:
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def run_modex(mesh: Mesh) -> List[Endpoint]:
    """Endpoint records for every rank (single controller: a local
    enumeration, as in the reference's singleton mode)."""
    hostname = socket.gethostname()
    endpoints = []
    for rank, dev in enumerate(mesh.devices.reshape(-1)):
        endpoints.append(Endpoint(
            rank=rank,
            device_id=int(dev.index or 0),
            process_index=0,
            platform=str(dev.type),
            device_kind=_device_kind(dev),
            coords=(rank,),
            host=hostname,
        ))
    return endpoints
