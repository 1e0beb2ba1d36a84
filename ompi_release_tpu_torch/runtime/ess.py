"""ESS — environment-specific bootstrap (``orte/mca/ess`` analogue).

Counterpart of ``ompi_release_tpu/runtime/ess.py``, singleton component
only: one controller process owning the devices it names. The device
set is torch devices: every visible CUDA card by default, or the one
device the caller asked for (``init(device=...)``). A CUDA request on a
machine without CUDA raises — the runtime never carries on silently on
the host.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..mca import component as mca_component
from ..utils.errors import ErrorCode, MPIError


def discover_devices(device=None) -> List[torch.device]:
    """The device set a singleton controller owns: ``device`` when
    given, else every CUDA card (``cuda:0`` first)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MPIError(
                ErrorCode.ERR_NOT_AVAILABLE,
                f"no CUDA device: the runtime runs on the card ({dev}) "
                "unless the caller asks for the host with device='cpu'",
            )
        if dev.index is None:
            if device is None:
                return [torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
            dev = torch.device("cuda", 0)
        if dev.index >= torch.cuda.device_count():
            raise MPIError(ErrorCode.ERR_NOT_AVAILABLE,
                           f"{dev} not present "
                           f"({torch.cuda.device_count()} CUDA devices)")
    return [dev]


class SingletonEss(mca_component.Component):
    """Single-controller bootstrap: the requested devices, process 0."""

    NAME = "singleton"
    PRIORITY = 10

    def bootstrap(self, device: Optional[object] = None):
        devices = discover_devices(device)
        return {
            "process_index": 0,
            "process_count": 1,
            "devices": devices,
            "local_devices": devices,
        }


ESS_FRAMEWORK = mca_component.framework(
    "ess", "environment-specific bootstrap (orte/mca/ess analogue)"
)
ESS_FRAMEWORK.register(SingletonEss())
