"""Predefined reduction operations — the ``ompi/op`` analogue, on torch
tensors (counterpart of ``ompi_release_tpu/ops/op.py``).

Each op is an elementwise combiner on tensors. The ``op`` framework
lets an accelerated component (the hand-written CUDA streaming SUM of
``ops/cuda_op.py``) claim the (op, dtype, size) shapes its kernel is
for; ``resolve`` walks the components in priority order exactly like
``ompi_op_base_op_select``.

Each op carries the metadata the collective decision rules need:
commutativity (tuned picks ring only for commutative ops) and an
identity element per dtype (for padded/segmented algorithms).
MINLOC/MAXLOC operate on a (value, index) pair carried as two tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from ..mca import component as mca_component


@dataclasses.dataclass(frozen=True)
class Op:
    """A reduction operator usable by collectives."""

    name: str
    fn: Callable[[Any, Any], Any]  # elementwise combiner a⊕b
    commutative: bool = True
    identity: Optional[Callable[[Any], Any]] = None  # dtype -> identity scalar
    is_pair_op: bool = False  # MINLOC/MAXLOC operate on (value, index)

    def identity_for(self, dtype) -> Any:
        if self.identity is None:
            raise ValueError(f"op {self.name} has no identity element")
        return self.identity(dtype)

    def __call__(self, a, b):
        return self.fn(a, b)

    def __repr__(self) -> str:
        return f"Op({self.name}, commutative={self.commutative})"


def _is_int(dtype) -> bool:
    return not dtype.is_floating_point and not dtype.is_complex \
        and dtype is not torch.bool


def _min_identity(dtype):
    if dtype is torch.bool:
        return True
    if _is_int(dtype):
        return torch.iinfo(dtype).max
    return float("inf")


def _max_identity(dtype):
    if dtype is torch.bool:
        return False
    if _is_int(dtype):
        return torch.iinfo(dtype).min
    return float("-inf")


def _band_identity(dtype):
    if dtype is torch.bool:
        return True
    return torch.iinfo(dtype).max if dtype is torch.uint8 else -1  # all bits set


SUM = Op("sum", lambda a, b: a + b, True, lambda d: 0)
PROD = Op("prod", lambda a, b: a * b, True, lambda d: 1)
MAX = Op("max", torch.maximum, True, _max_identity)
MIN = Op("min", torch.minimum, True, _min_identity)
LAND = Op("land", torch.logical_and, True, lambda d: True)
LOR = Op("lor", torch.logical_or, True, lambda d: False)
LXOR = Op("lxor", torch.logical_xor, True, lambda d: False)
BAND = Op("band", lambda a, b: a & b, True, _band_identity)
BOR = Op("bor", lambda a, b: a | b, True, lambda d: 0)
BXOR = Op("bxor", lambda a, b: a ^ b, True, lambda d: 0)
REPLACE = Op("replace", lambda a, b: b, False)  # MPI_REPLACE (RMA)
NO_OP = Op("no_op", lambda a, b: a, False)  # MPI_NO_OP (RMA get-accumulate)


def _maxloc_fn(a, b):
    """a, b are (value, index) tuples; ties pick the lower index (MPI)."""
    av, ai = a
    bv, bi = b
    take_a = (av > bv) | ((av == bv) & (ai <= bi))
    return torch.where(take_a, av, bv), torch.where(take_a, ai, bi)


def _minloc_fn(a, b):
    av, ai = a
    bv, bi = b
    take_a = (av < bv) | ((av == bv) & (ai <= bi))
    return torch.where(take_a, av, bv), torch.where(take_a, ai, bi)


MAXLOC = Op("maxloc", _maxloc_fn, True, is_pair_op=True)
MINLOC = Op("minloc", _minloc_fn, True, is_pair_op=True)

PREDEFINED_OPS: Dict[str, Op] = {
    op.name: op
    for op in [SUM, PROD, MAX, MIN, LAND, LOR, LXOR, BAND, BOR, BXOR,
               MAXLOC, MINLOC, REPLACE, NO_OP]
}


def user_op(name: str, fn: Callable, commute: bool = True,
            identity: Optional[Callable] = None) -> Op:
    """MPI_Op_create analogue: wrap a user combiner over torch tensors."""
    return Op(name, fn, commutative=commute, identity=identity)


class TorchOpComponent(mca_component.Component):
    """Default op component: plain PyTorch elementwise combiners (always
    available; the counterpart of the reference's ``xla`` op component).
    """

    NAME = "torch"
    PRIORITY = 10

    def lookup(self, name: str, dtype=None, nbytes: int = 0
               ) -> Optional[Op]:
        return PREDEFINED_OPS.get(name)


OP_FRAMEWORK = mca_component.framework(
    "op", "reduction operator kernels (ompi/mca/op analogue)"
)
OP_FRAMEWORK.register(TorchOpComponent())


def reduce_local(inbuf, inoutbuf, op: Op):
    """MPI_Reduce_local: combine two local buffers, ``inout = in OP
    inout`` — no communication. Pair ops take/return ``(values,
    indices)`` tuples. Routed through the op framework, so the CUDA
    component claims the shapes its kernel is for, exactly like the
    collectives' local reduction steps."""
    if op.is_pair_op:
        (va, ia), (vb, ib) = inbuf, inoutbuf
        return op((torch.as_tensor(va), torch.as_tensor(ia)),
                  (torch.as_tensor(vb), torch.as_tensor(ib)))
    a = torch.as_tensor(inbuf)
    b = torch.as_tensor(inoutbuf)
    resolved = resolve(op, a.dtype, a.numel() * a.element_size())
    return resolved(a, b)


def resolve(op: Op, dtype=None, nbytes: int = 0) -> Op:
    """Accelerated-kernel resolution (``ompi/mca/op`` select): query
    components highest-priority first with the reduction's shape
    context; the first claim wins. Ops no component knows (user ops)
    pass through unchanged. Accelerated ops carry distinct names
    (``sum[cuda]``) and are distinct objects, so per-comm program
    caches keyed by the op object never mix two combiners. The
    framework include/exclude variable applies (``--mca op ^cuda``
    turns the CUDA component off job-wide)."""
    for _prio, _comp, module in OP_FRAMEWORK.available():
        found = module.lookup(op.name, dtype=dtype, nbytes=int(nbytes))
        if found is not None:
            return found
    return op
