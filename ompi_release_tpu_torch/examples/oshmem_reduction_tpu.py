"""oshmem_max_reduction.c + oshmem_circular_shift.c +
oshmem_strided_puts.c rolled into one acceptance program.

Port of ``examples/oshmem_reduction_tpu.py``: symmetric allocation, a
max_to_all reduction, neighbour puts (circular shift) and element-wise
(strided-style) puts into a peer's symmetric array. Run on the card:
``python -m ompi_release_tpu_torch.examples.oshmem_reduction_tpu`` (8
virtual PEs on ``cuda:0``); on the host: ``main(device="cpu")``.
"""

import sys

import numpy as np

import ompi_release_tpu_torch as mpi
from ompi_release_tpu_torch.oshmem import shmem

#: PEs in main(): the JAX package's 8-device test mesh
VIRTUAL_RANKS = 8


def main(device=None) -> int:
    world = mpi.init(cli_args=["--mca", "runtime_virtual_ranks",
                               str(VIRTUAL_RANKS)], device=device)
    ctx = shmem.shmem_init(world)
    n = ctx.n_pes

    # -- max reduction (oshmem_max_reduction.c) --------------------------
    per_pe = np.stack([np.arange(4, dtype=np.int32) + pe
                       for pe in range(n)])
    mx = ctx.max_to_all(per_pe).cpu().numpy()
    expect = per_pe.max(axis=0)
    assert (mx[0] == expect).all(), (mx, expect)
    print(f"max_to_all over {n} PEs: {mx[0].tolist()}")

    # -- circular shift (oshmem_circular_shift.c): each PE puts its id
    #    into its right neighbour's symmetric slot -----------------------
    slot = ctx.malloc((1,), np.int32)
    ctx.barrier_all()
    for pe in range(n):
        ctx.put(slot, np.full(1, pe, np.int32), pe=(pe + 1) % n)
    ctx.barrier_all()
    for pe in range(n):
        got = int(ctx.get(slot, pe=pe)[0])
        assert got == (pe - 1) % n, (pe, got)
    print("circular shift: every PE holds its left neighbour's id")

    # -- strided-style puts (oshmem_strided_puts.c): write every other
    #    element of a peer PE's array (1 % n keeps a 1-PE run valid) --
    peer = 1 % n
    arr = ctx.malloc((8,), np.float32)
    ctx.barrier_all()
    ctx.put(arr, np.zeros(8, np.float32), pe=peer)
    for i in range(0, 8, 2):
        ctx.put_elem(arr, np.float32(i * 10), i, pe=peer)
    ctx.quiet()
    got = ctx.get(arr, pe=peer).cpu().numpy()
    assert (got[::2] == np.arange(0, 8, 2) * 10).all(), got
    assert (got[1::2] == 0).all(), got
    print(f"strided puts into PE {peer}: {got.tolist()}")

    slot.free()
    arr.free()
    shmem.shmem_finalize()
    mpi.finalize()
    print("oshmem_reduction complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
