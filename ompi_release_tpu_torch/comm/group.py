"""Process groups — the ``ompi/group`` analogue (the port's own copy of
``ompi_release_tpu/comm/group.py``).

A group is an ordered set of world ranks (mesh flat positions). All of
MPI's group calculus is here: incl/excl/range variants, set operations,
rank translation, comparison. Groups are immutable value objects;
communicators are created *from* groups (``MPI_Comm_create``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..utils.errors import ErrorCode, MPIError

# comparison results (MPI_IDENT/SIMILAR/UNEQUAL)
IDENT = 0
SIMILAR = 1
UNEQUAL = 2

UNDEFINED = -1  # MPI_UNDEFINED


class Group:
    __slots__ = ("_ranks", "_index")

    def __init__(self, ranks: Sequence[int]) -> None:
        ranks = tuple(int(r) for r in ranks)
        if len(set(ranks)) != len(ranks):
            raise MPIError(ErrorCode.ERR_GROUP, f"duplicate ranks: {ranks}")
        self._ranks = ranks
        self._index = {r: i for i, r in enumerate(ranks)}

    # -- queries -----------------------------------------------------------
    @property
    def size(self) -> int:
        return len(self._ranks)

    @property
    def world_ranks(self) -> Tuple[int, ...]:
        return self._ranks

    def rank_of(self, world_rank: int) -> int:
        """Local rank of a world rank, or UNDEFINED."""
        return self._index.get(int(world_rank), UNDEFINED)

    def world_rank(self, local_rank: int) -> int:
        if not 0 <= local_rank < self.size:
            raise MPIError(ErrorCode.ERR_RANK, f"rank {local_rank} not in group")
        return self._ranks[local_rank]

    def translate_ranks(self, ranks: Sequence[int],
                        other: "Group") -> List[int]:
        """MPI_Group_translate_ranks: my local ranks -> other's locals."""
        return [other.rank_of(self.world_rank(r)) for r in ranks]

    def compare(self, other: "Group") -> int:
        if self._ranks == other._ranks:
            return IDENT
        if set(self._ranks) == set(other._ranks):
            return SIMILAR
        return UNEQUAL

    # -- constructors ------------------------------------------------------
    def incl(self, ranks: Sequence[int]) -> "Group":
        return Group([self.world_rank(r) for r in ranks])

    def excl(self, ranks: Sequence[int]) -> "Group":
        drop = {self.world_rank(r) for r in ranks}
        return Group([r for r in self._ranks if r not in drop])

    def range_incl(self, ranges: Sequence[Tuple[int, int, int]]) -> "Group":
        """ranges = [(first, last, stride), ...], inclusive like MPI."""
        picked: List[int] = []
        for first, last, stride in ranges:
            if stride == 0:
                raise MPIError(ErrorCode.ERR_ARG, "zero stride")
            r = first
            if stride > 0:
                while r <= last:
                    picked.append(r)
                    r += stride
            else:
                while r >= last:
                    picked.append(r)
                    r += stride
        return self.incl(picked)

    def range_excl(self, ranges: Sequence[Tuple[int, int, int]]) -> "Group":
        inc = self.range_incl(ranges)
        drop = set(inc._ranks)
        return Group([r for r in self._ranks if r not in drop])

    def union(self, other: "Group") -> "Group":
        extra = [r for r in other._ranks if r not in self._index]
        return Group(self._ranks + tuple(extra))

    def intersection(self, other: "Group") -> "Group":
        return Group([r for r in self._ranks if other.rank_of(r) != UNDEFINED])

    def difference(self, other: "Group") -> "Group":
        return Group([r for r in self._ranks if other.rank_of(r) == UNDEFINED])

    def __len__(self) -> int:
        return self.size

    def __eq__(self, other) -> bool:
        return isinstance(other, Group) and self._ranks == other._ranks

    def __hash__(self) -> int:
        return hash(self._ranks)

    def __repr__(self) -> str:
        return f"Group({list(self._ranks)})"


EMPTY = Group(())
