"""ring_c.c analogue (BASELINE config #1): a token circles the ring.

Port of ``examples/ring_tpu.py``. Rank 0 seeds a lap counter; each rank
receives from rank-1 and forwards to rank+1; rank 0 decrements per lap;
everyone exits after passing a 0, and rank 0 drains the final 0.

Run on the card: ``python -m ompi_release_tpu_torch.examples.ring_tpu``
(8 virtual ranks on ``cuda:0``, the ring over the first 4); on the
host: ``main(device="cpu")``.
"""

import sys
from typing import Tuple

import numpy as np

import ompi_release_tpu_torch as mpi

#: ranks WORLD gets in main(): the JAX package's 8-device test mesh
VIRTUAL_RANKS = 8
LAPS = 3


def ring(world, laps: int = LAPS, tag: int = 1) -> Tuple[int, int]:
    """Drive the token ring over the first ``min(4, world.size)`` ranks
    of ``world`` (driver mode: one controller plays every rank — the
    reference's oversubscribed-mpirun test style, the message pattern of
    examples/ring_c.c:19-61). Returns (receives inside the loop, the
    value rank 0 drains at the end): ``(n - 1) + laps * n`` and 0."""
    n = min(4, world.size)
    ring_comm = world.create(world.group.incl(list(range(n))), name="ring")
    ring_comm.send(np.int32(laps), dest=1 % n, tag=tag, rank=0)
    done = [False] * n
    passes = 0
    while not all(done):
        for r in range(n):
            if done[r]:
                continue
            st = ring_comm.iprobe(source=(r - 1) % n, tag=tag, rank=r)
            if st is None:
                continue
            val, _ = ring_comm.recv(source=(r - 1) % n, tag=tag, rank=r)
            v = int(val)
            passes += 1
            if r == 0:
                v -= 1
                print(f"rank 0: {v} laps to go")
            ring_comm.send(np.int32(v), dest=(r + 1) % n, tag=tag, rank=r)
            if v == 0:
                done[r] = True
    # rank 0 drains the final 0 off the ring
    last, _ = ring_comm.recv(source=n - 1, tag=tag, rank=0)
    ring_comm.free()
    print(f"ring complete: {passes} passes over {n} ranks, {laps} laps")
    return passes, int(last)


def main(device=None) -> int:
    world = mpi.init(cli_args=["--mca", "runtime_virtual_ranks",
                               str(VIRTUAL_RANKS)], device=device)
    ring(world)
    mpi.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
