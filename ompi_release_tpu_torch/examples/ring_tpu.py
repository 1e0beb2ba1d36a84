"""ring_c.c analogue (BASELINE config #1): a token circles the ring.

Port of ``examples/ring_tpu.py``. Rank 0 seeds a lap counter; each rank
receives from rank-1 and forwards to rank+1; rank 0 decrements per lap;
everyone exits after passing a 0, and rank 0 drains the final 0.

Run on the card: ``python -m ompi_release_tpu_torch.examples.ring_tpu``
(8 virtual ranks on ``cuda:0``, the ring over the first 4); on the
host: ``main(device="cpu")``. Under the launcher,
``python -m ompi_release_tpu_torch.tools.tpurun -n 2 python -m
ompi_release_tpu_torch.examples.ring_tpu``, the 8 ranks are split over
the workers (4 each) and the token circles all of COMM_WORLD, crossing
the process boundary twice a lap; each worker plays its own ranks.
"""

import os
import sys
from typing import Optional, Tuple

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


def ring_spanning(world, laps: int = LAPS, tag: int = 1
                  ) -> Tuple[int, Optional[int]]:
    """The token ring over every rank of a COMM_WORLD spanning worker
    processes: this process plays only its local ranks, and the hops
    between the last rank of one worker and the first of the next go
    over the wire. Returns (this process's receives inside the loop,
    the value rank 0 drains at the end, or None where rank 0 is not
    local); summed over the workers the receives are
    ``(n - 1) + laps * n``."""
    n = world.size
    local = list(world.local_comm_ranks)
    if 0 in local:
        world.send(np.int32(laps), dest=1 % n, tag=tag, rank=0)
    done = {r: False for r in local}
    passes = 0
    while not all(done.values()):
        for r in local:
            if done[r]:
                continue
            st = world.iprobe(source=(r - 1) % n, tag=tag, rank=r)
            if st is None:
                continue
            val, _ = world.recv(source=(r - 1) % n, tag=tag, rank=r)
            v = int(val)
            passes += 1
            if r == 0:
                v -= 1
                print(f"rank 0: {v} laps to go")
            world.send(np.int32(v), dest=(r + 1) % n, tag=tag, rank=r)
            if v == 0:
                done[r] = True
    last = None
    if 0 in local:
        val, _ = world.recv(source=n - 1, tag=tag, rank=0)
        last = int(val)
    print(f"ring complete here: {passes} passes by ranks {local}")
    return passes, last


def main(device=None) -> int:
    # under tpurun the world's ranks are split over the workers
    nvirt = VIRTUAL_RANKS // int(os.environ.get("OMPITPU_NUM_NODES", "1"))
    world = mpi.init(cli_args=["--mca", "runtime_virtual_ranks",
                               str(max(1, nvirt))], device=device)
    if world.spans_processes:
        ring_spanning(world)
    else:
        ring(world)
    mpi.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
