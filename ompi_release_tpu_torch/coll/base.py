"""coll framework base: per-communicator, per-operation selection.

Counterpart of ``ompi_release_tpu/coll/base.py`` and of
``ompi/mca/coll/base/coll_base_comm_select.c:66-88``: at communicator
creation every coll component is queried with the comm; each returned
module contributes implementations for the operations it supports, and
for every operation the providers form a chain, highest priority first.
A provider may decline at call time by returning None and the next one
takes over.
"""

from __future__ import annotations

from typing import Callable, Dict

from ..mca import component as mca_component
from ..utils import output
from ..utils.errors import ErrorCode, MPIError

_log = output.stream("coll")

#: operations every communicator must end up with (the coll.h fn
#: table's blocking half)
OP_NAMES = (
    "allreduce", "reduce", "bcast", "allgather", "gather", "scatter",
    "reduce_scatter_block", "alltoall", "scan", "exscan", "barrier",
    # v-variants (per-rank counts; coll_tuned_alltoallv.c etc.)
    "alltoallv", "allgatherv", "gatherv", "scatterv", "reduce_scatter",
)

#: a provider's "I ran, and MPI leaves this rank's result undefined"
#: (gatherv off-root on a spanning comm): the dispatcher returns None
#: for it instead of treating None as a decline
NO_RESULT = object()

COLL_FRAMEWORK = mca_component.framework(
    "coll", "collective operations (ompi/mca/coll analogue)"
)


def comm_select(comm) -> Dict[str, Callable]:
    """Install the per-comm collective table (the ``c_coll`` analogue)."""
    # import components so they self-register before first selection
    from . import components as _components  # noqa: F401

    chains: Dict[str, list] = {}
    providers: Dict[str, list] = {}
    for prio, comp, module in COLL_FRAMEWORK.available(comm):
        for op_name, fn in module.fns().items():
            chains.setdefault(op_name, []).append(fn)
            providers.setdefault(op_name, []).append(comp.NAME)

    def _dispatcher(op_name: str, chain) -> Callable:
        def call(comm_, *args, **kw):
            for fn in chain:
                res = fn(comm_, *args, **kw)
                if res is NO_RESULT:
                    return None
                if res is not None or op_name == "barrier":
                    return res
            raise MPIError(
                ErrorCode.ERR_NOT_AVAILABLE,
                f"every {op_name} provider declined on {comm_.name}",
            )

        return call

    table: Dict[str, Callable] = {
        name: _dispatcher(name, chain) for name, chain in chains.items()
    }
    missing = [o for o in OP_NAMES if o not in table]
    if missing:
        output.show_help(
            "coll", "missing-ops", comm=comm.name, ops=", ".join(missing)
        )
    _log.verbose(2, f"{comm.name}: coll providers {providers}")
    comm._coll_providers = providers
    return table


output.register_help(
    "coll",
    {
        "missing-ops": (
            "Communicator {comm} has no implementation for collective "
            "operation(s): {ops}. They will raise if invoked."
        ),
    },
)
