"""hello_oshmem_c.c analogue: every PE reports its identity.

Port of ``examples/hello_oshmem_tpu.py``. Run on the card:
``python -m ompi_release_tpu_torch.examples.hello_oshmem_tpu`` (8
virtual PEs on ``cuda:0``); on the host: ``main(device="cpu")``.
"""

import sys

import ompi_release_tpu_torch as mpi
from ompi_release_tpu_torch.oshmem import shmem

#: PEs in main(): the JAX package's 8-device test mesh
VIRTUAL_RANKS = 8


def main(device=None) -> int:
    world = mpi.init(cli_args=["--mca", "runtime_virtual_ranks",
                               str(VIRTUAL_RANKS)], device=device)
    ctx = shmem.shmem_init(world)
    # driver mode: one controller speaks for every PE
    for pe in range(ctx.n_pes):
        print(f"Hello, world, I am {pe} of {ctx.n_pes}")
    shmem.shmem_finalize()
    mpi.finalize()
    print("hello_oshmem complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
