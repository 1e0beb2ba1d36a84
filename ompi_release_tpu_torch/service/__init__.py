"""service — the multi-tenant service plane.

A resident daemon (:mod:`.daemon`, ``tpu-serviced``) admits many
independently launched jobs as tenants of one fabric:
:mod:`.tenant` is the admission-control/lease registry over the
tenant cid-band discipline of :mod:`..ft.ulfm`; :mod:`.qos` is the
per-class lane partitioning + weighted-fair fragment scheduling the
:class:`~..runtime.wire.WireRouter` engages under the
``wire_qos_classes`` cvar. Import-light: nothing here touches jax.
"""

from . import qos, tenant  # noqa: F401

__all__ = ["qos", "tenant", "daemon"]


def __getattr__(name):
    if name == "daemon":
        import importlib

        mod = importlib.import_module(".daemon", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
