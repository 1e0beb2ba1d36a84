"""Static P2P schedules over the rank axis.

Counterpart of ``ompi_release_tpu/p2p/spmd.py``. There a fixed
send/recv pattern is one ``lax.ppermute`` compiled into the surrounding
XLA program (the reference's isend/irecv schedule in
``coll_tuned_util.c:50-59``); here it is the same index gather along the
leading rank axis that ``coll/spmd.py`` uses for ``ppermute``: row
``src`` of the ``(n, ...)`` tensor lands in row ``dst``, and ranks that
receive nothing get zeros. The host PML (``pml.py``) is for dynamic
patterns only.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..coll.spmd import ppermute


def sendrecv(x: torch.Tensor, perm: Sequence[Tuple[int, int]]
             ) -> torch.Tensor:
    """MPI_Sendrecv over a static pattern: each (src, dst) pair is one
    edge; ranks not receiving get zeros (ppermute semantics)."""
    return ppermute(x, list(perm))


def ring_shift(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """Rotate rank rows around the ring by ``shift`` (ring_c.c
    pattern)."""
    n = x.shape[0]
    return ppermute(x, [(i, (i + shift) % n) for i in range(n)])


def halo_exchange(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Neighbor exchange: returns (from_left, from_right) for a 1-D
    non-periodic decomposition; boundary ranks receive zeros."""
    n = x.shape[0]
    from_left = ppermute(x, [(i, i + 1) for i in range(n - 1)])
    from_right = ppermute(x, [(i + 1, i) for i in range(n - 1)])
    return from_left, from_right
