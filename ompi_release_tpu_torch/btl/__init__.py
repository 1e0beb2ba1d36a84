"""btl — pluggable transfer layer (ompi/mca/btl + bml analogue; the
port's counterpart of ``ompi_release_tpu/btl``). The native datapath
component (``nativewire``) is not ported yet."""

from .base import BTL_FRAMEWORK, BmlEndpoint, BmlR2, BtlModule
from . import components as _components  # noqa: F401  (self-register)

__all__ = ["BTL_FRAMEWORK", "BmlEndpoint", "BmlR2", "BtlModule"]
