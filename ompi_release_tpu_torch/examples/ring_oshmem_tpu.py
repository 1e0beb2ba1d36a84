"""ring_oshmem_c.c analogue: a token circles the PEs via one-sided
puts + wait_until instead of send/recv.

Port of ``examples/ring_oshmem_tpu.py``. Each PE waits until its
symmetric flag holds the lap count its left neighbour put there, then
decrements (PE 0) and puts onward. Run on the card:
``python -m ompi_release_tpu_torch.examples.ring_oshmem_tpu`` (8
virtual PEs on ``cuda:0``); on the host: ``main(device="cpu")``.
"""

import sys

import numpy as np

import ompi_release_tpu_torch as mpi
from ompi_release_tpu_torch.oshmem import shmem

#: PEs in main(): the JAX package's 8-device test mesh
VIRTUAL_RANKS = 8
LAPS = 3


def main(device=None) -> int:
    world = mpi.init(cli_args=["--mca", "runtime_virtual_ranks",
                               str(VIRTUAL_RANKS)], device=device)
    ctx = shmem.shmem_init(world)
    n = ctx.n_pes
    # symmetric flag per PE: -1 = empty, >=0 = token with value
    flag = ctx.malloc((1,), np.int32)
    ctx.barrier_all()
    for pe in range(n):
        ctx.put(flag, np.full(1, -1, np.int32), pe=pe)
    ctx.quiet()

    passes = 0
    ctx.put_elem(flag, np.int32(LAPS), 0, pe=0)  # seed at PE 0
    pe = 0
    while True:
        ctx.wait_until(flag, "ge", 0, pe=pe)
        token = int(ctx.get(flag, pe=pe)[0])
        ctx.put_elem(flag, np.int32(-1), 0, pe=pe)  # consume
        passes += 1
        if pe == 0 and passes > 1:
            token -= 1
            print(f"PE 0: {token} laps to go")
        if token == 0 and pe == n - 1:
            break
        ctx.put_elem(flag, np.int32(token), 0, pe=(pe + 1) % n)
        ctx.quiet()
        pe = (pe + 1) % n
    ctx.barrier_all()
    flag.free()
    shmem.shmem_finalize()
    mpi.finalize()
    print(f"ring_oshmem complete: {passes} passes over {n} PEs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
