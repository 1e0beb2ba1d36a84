"""Donated-buffer liveness checking — the memchecker analogue.

Counterpart of ``ompi_release_tpu/utils/memchecker.py``. The reference's
``opal/mca/memchecker/valgrind`` marks user buffers inaccessible while
the library owns them (``memchecker_valgrind_module.c:98-151``),
catching read-before-arrival and buffer-reuse races in user code.

The JAX package's ownership transfer is buffer DONATION: an array passed
through ``jax.jit(..., donate_argnums=...)`` is consumed and its memory
reused. PyTorch has no donation, so the port defines its counterpart:
:func:`donating_fn` calls a function and then releases the storage of
each donated input tensor that the output does not alias
(``untyped_storage().resize_(0)``: the memory goes back to the
allocator, as a donated buffer's does). A released tensor keeps its
shape but has no storage, which is what :func:`_is_deleted` reads. An
input the output aliases (an in-place update) lives on as the output
and is not released. This module is the provenance layer:

* :func:`mark_donated` — record that an operation took ownership (the
  MAKE_MEM_NOACCESS annotation).
* :func:`check` / :func:`assert_all_alive` — validate liveness before
  use; a released tensor raises ``ERR_BUFFER`` naming the recorded
  owner and the leaf.
* :func:`donating_fn` — call with donation semantics, marking every
  input it releases.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..mca import pvar
from . import pytree
from .errors import ErrorCode, MPIError

_donations = pvar.counter(
    "memchecker_donations", "buffers marked donated (ownership taken)"
)
_violations = pvar.counter(
    "memchecker_violations", "accesses to donated/deleted buffers caught"
)

_lock = threading.Lock()
#: id(tensor) -> (owner description, weakref) — weakrefs let entries
#: vanish with the tensor (ids are reused; a live entry whose weakref
#: died is stale and ignored)
_owners: Dict[int, Tuple[str, Any]] = {}


def _is_deleted(t) -> bool:
    """A tensor whose storage was released: no bytes under a non-empty
    shape."""
    return (isinstance(t, torch.Tensor) and t.numel() > 0
            and t.untyped_storage().nbytes() == 0)


def mark_donated(t, owner: str) -> None:
    """Record that ``owner`` (an operation name/site) took ownership of
    ``t``'s storage. Later :func:`check` failures name it."""
    _donations.add()
    key = id(t)
    try:
        # the weakref's callback removes the entry when the tensor is
        # garbage-collected — without it the registry grows one entry
        # per donated buffer for the life of the process
        ref = weakref.ref(t, lambda _r, _k=key: _owners.pop(_k, None))
    except TypeError:
        ref = None
    with _lock:
        _owners[key] = (owner, ref)


def owner_of(t) -> Optional[str]:
    """The recorded owner that consumed ``t``, if any."""
    with _lock:
        entry = _owners.get(id(t))
    if entry is None:
        return None
    owner, ref = entry
    if ref is not None and ref() is not t:
        return None  # stale id reuse
    return owner


def check(t, what: str = "buffer"):
    """Validate ``t`` is live; returns it. A donated tensor raises
    ERR_BUFFER naming the operation that consumed it — the
    read-before-arrival / buffer-reuse diagnostic."""
    if _is_deleted(t):
        _violations.add()
        owner = owner_of(t)
        raise MPIError(
            ErrorCode.ERR_BUFFER,
            f"{what} was donated"
            + (f" to {owner}" if owner else "")
            + " and its memory has been released — using it again is a "
            "buffer-liveness violation (memchecker)",
        )
    return t


def assert_all_alive(tree, what: str = "pytree") -> None:
    """Walk a pytree (``utils/pytree.py``, JAX's leaf order) and
    :func:`check` every tensor leaf (the quiesce-before-checkpoint
    validation: a snapshot must not contain consumed buffers)."""
    for i, leaf in enumerate(pytree.leaves(tree)):
        if isinstance(leaf, torch.Tensor):
            check(leaf, what=f"{what} leaf {i}")


def _tensor_leaves(tree):
    return [t for t in pytree.leaves(tree) if isinstance(t, torch.Tensor)]


def donating_fn(fn, donate_argnums: Sequence[int], owner: str):
    """``fn`` with donation: the call rejects already-consumed inputs
    BEFORE it runs, then releases the storage of every donated input
    tensor the output does not alias and marks it, so a later use raises
    with ``owner`` in the message."""
    donate_argnums = tuple(donate_argnums)

    def call(*args, **kw):
        # walk the LEAVES — the argument may be a pytree whose container
        # has no liveness of its own
        donated = []
        for i in donate_argnums:
            if i < len(args):
                for t in _tensor_leaves(args[i]):
                    check(t, what=f"{owner} argument {i}")
                    donated.append(t)
        out = fn(*args, **kw)
        kept = {t.untyped_storage().data_ptr() for t in _tensor_leaves(out)}
        for t in donated:
            if t.untyped_storage().data_ptr() not in kept:
                t.untyped_storage().resize_(0)
                mark_donated(t, owner)
        return out

    call.__wrapped__ = fn
    return call
