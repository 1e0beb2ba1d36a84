"""The job's communicator-id space: every band, the FT band's parent
slots and the dpm cid blocks, in one place.

The wire's collective tags hold a cid below :data:`CID_LIMIT`
(``1 << 20``)::

    [0, 1 << 19)                    the shared counter (CID_BAND)
      [1 << 18, 1 << 19)            tenant bands (the service plane,
                                    ROADMAP item 16b): 64 x 4096
    [1 << 19, 1 << 19 | 1 << 18)    the FT band (ft_cid): 16 epochs x
                                    16384 parent slots
    [1 << 19 | 1 << 18, 1 << 20)    dpm cid blocks (DPM_CID_BASE):
                                    1024 blocks of 256 cids
    < 0                             runtime-private comms

- The **shared counter** is identical on every process because every
  process creates every communicator in the same order.
- A **dpm block** holds the cids of one connect/accept pair and every
  comm derived from it; only the processes taking part create them.
- A **rebuilt** communicator (ULFM shrink or respawn) takes
  :func:`ft_cid` of the agreed epoch and its lineage (the cid of the
  comm the rebuild chain started from), so survivors and a replacement
  whose counter restarted from zero mint the same one.

The FT band and the dpm blocks are disjoint, so a rebuild never lands on
a live connect/accept pair. A lineage takes a parent slot by the band it
was born in: slots ``[0, 8192)`` for the shared counter's, the tenants'
and runtime-private lineages (``abs(parent) % 8192``), slots
``[8192, 16384)`` for dpm lineages (``8192 + (parent - DPM_CID_BASE) %
8192``, 32 blocks before two alias). So a shared-counter lineage and a
dpm lineage never share a slot, and two rebuilds in one epoch collide
only if their lineages lie 8192 cids apart within one of the two
halves.

Pure integer arithmetic, no imports beyond the error type: the wire's
hot path and ``ft/ulfm`` use it.
"""

from __future__ import annotations

from .errors import ErrorCode, MPIError

#: the wire's collective tags hold a cid below this bound
CID_LIMIT = 1 << 20
#: the shared counter stays below this bound
CID_BAND = 1 << 19

#: rebuilt communicators draw their cid from this band
FT_CID_BASE = CID_BAND
#: epochs before :func:`ft_cid` wraps, and parent slots per epoch
FT_CID_EPOCHS = 16
FT_CID_SLOTS = 16384
#: the FT band's end: dpm's cid blocks start here
FT_CID_LIMIT = FT_CID_BASE + FT_CID_EPOCHS * FT_CID_SLOTS
#: parent slots of lineages outside the dpm band; dpm lineages take
#: the other half
_FT_SHARED_SLOTS = FT_CID_SLOTS // 2

#: cids per connect/accept pair: the pair's three, and room for the
#: comms derived from it (merge, dup, split)
DPM_CID_BLOCK = 256
DPM_CID_BASE = FT_CID_LIMIT
DPM_CID_BLOCKS = (CID_LIMIT - DPM_CID_BASE) // DPM_CID_BLOCK  # 1024

#: multi-tenant cid banding (the service plane, ROADMAP item 16b):
#: tenant t's communicators draw cids from the band
#: [TENANT_CID_BASE + t*TENANT_CID_SLOT, +TENANT_CID_SLOT), directly
#: below the FT band — so revoking ONE tenant's comms is a range
#: operation that can never touch another tenant. Each 4096-cid slot
#: is split in half: app comms use the lower 2048 ids, shrink/rebuild
#: comms (:func:`ft_cid` with a tenant) the upper 2048 (8 epochs x 256
#: parent slots).
TENANT_CID_BASE = 1 << 18
TENANT_CID_SLOT = 4096
MAX_TENANTS = (FT_CID_BASE - TENANT_CID_BASE) // TENANT_CID_SLOT  # 64
_TENANT_APP_SLOTS = TENANT_CID_SLOT // 2


def tenant_band(tenant: int) -> tuple:
    """``[lo, hi)`` cid range owned by ``tenant`` — THE range every
    band-scoped operation (revoke, sentinel clear, sampler scoping)
    keys on."""
    t = int(tenant)
    if not 0 <= t < MAX_TENANTS:
        raise MPIError(ErrorCode.ERR_ARG,
                       f"tenant id {t} outside [0, {MAX_TENANTS})")
    lo = TENANT_CID_BASE + t * TENANT_CID_SLOT
    return lo, lo + TENANT_CID_SLOT


def tenant_cid(tenant: int, k: int) -> int:
    """The ``k``-th application cid of ``tenant``'s band (the lower
    half of the slot; rebuild cids live in the upper half via
    :func:`ft_cid`)."""
    lo, _hi = tenant_band(tenant)
    return lo + int(k) % _TENANT_APP_SLOTS


def tenant_of_cid(cid: int) -> int:
    """Which tenant's band ``cid`` falls in, or -1 for every cid
    outside the tenant band — pure math, safe on any hot path."""
    c = int(cid)
    if TENANT_CID_BASE <= c < FT_CID_BASE:
        return (c - TENANT_CID_BASE) // TENANT_CID_SLOT
    return -1


def ft_parent_slot(parent_cid: int) -> int:
    """The FT band's parent slot of a lineage (see the module
    docstring): dpm lineages in the upper half, every other in the
    lower."""
    p = int(parent_cid)
    if DPM_CID_BASE <= p < CID_LIMIT:
        return _FT_SHARED_SLOTS + (p - DPM_CID_BASE) % _FT_SHARED_SLOTS
    return abs(p) % _FT_SHARED_SLOTS


def ft_cid(epoch: int, parent_cid: int, tenant: int = -1) -> int:
    """Deterministic cid for a shrink/rebuild communicator: derived
    from the agreed epoch plus the parent comm's (SPMD-agreed) lineage,
    so no process-local counter is involved. The shrink-every-comm
    recovery pattern needs DISTINCT cids for distinct parents at one
    epoch, while the epoch wraps — a wrap collision can only hit the
    same parent ``FT_CID_EPOCHS`` recovery epochs later, where the
    occupant is that lineage's old REVOKED comm, which Communicator
    evicts on explicit-cid rebuild.

    ``tenant >= 0`` scopes the rebuild to that tenant's cid band (the
    upper half of its slot, 8 epochs x 256 parent slots)."""
    if tenant >= 0:
        lo, hi = tenant_band(tenant)
        cid = (lo + _TENANT_APP_SLOTS + (int(epoch) % 8) * 256
               + (abs(int(parent_cid)) % 256))
        if cid >= hi:  # pragma: no cover - arithmetic bound
            raise MPIError(
                ErrorCode.ERR_INTERN,
                f"tenant ft cid {cid} escapes band [{lo}, {hi})",
            )
        return cid
    return (FT_CID_BASE + (int(epoch) % FT_CID_EPOCHS) * FT_CID_SLOTS
            + ft_parent_slot(parent_cid))


def dpm_block_base(k: int) -> int:
    """The first cid of dpm block ``k`` (``0 <= k < DPM_CID_BLOCKS``)."""
    if not 0 <= int(k) < DPM_CID_BLOCKS:
        raise MPIError(ErrorCode.ERR_INTERN,
                       "the cid band of connect/accept pairs is "
                       "exhausted")
    return DPM_CID_BASE + int(k) * DPM_CID_BLOCK
