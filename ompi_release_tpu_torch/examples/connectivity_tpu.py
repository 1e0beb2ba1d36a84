"""connectivity_c.c analogue: every pair exchanges a message.

Port of ``examples/connectivity_tpu.py``: one controller plays every
rank of WORLD (driver mode); each pair i < j sends i -> j with
``isend`` and j -> i with ``send``, each checked on receipt. Run on the
card: ``python -m ompi_release_tpu_torch.examples.connectivity_tpu``
(8 virtual ranks on ``cuda:0``); on the host: ``main(device="cpu")``.
"""

import sys

import numpy as np

import ompi_release_tpu_torch as mpi

#: ranks WORLD gets in main(): the JAX package's 8-device test mesh
VIRTUAL_RANKS = 8


def main(device=None) -> int:
    world = mpi.init(cli_args=["--mca", "runtime_virtual_ranks",
                               str(VIRTUAL_RANKS)], device=device)
    n = world.size
    checked = 0
    for i in range(n):
        for j in range(i + 1, n):
            req = world.isend(np.int32(i * 1000 + j), dest=j, tag=7, rank=i)
            val, _ = world.recv(source=i, tag=7, rank=j)
            req.wait()
            assert int(val) == i * 1000 + j
            # and the reverse direction
            world.send(np.int32(j * 1000 + i), dest=i, tag=8, rank=j)
            val, _ = world.recv(source=j, tag=8, rank=i)
            assert int(val) == j * 1000 + i
            checked += 1
    print(f"connectivity OK: {checked} pairs fully connected "
          f"({n} ranks)")
    mpi.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
