"""Unified multi-controller world tour — the acceptance program for the
cross-process surface.

Port of ``examples/unified_world_tpu.py``. Under ``tools.tpurun -n 2``,
or in two processes started by hand with the distributed bootstrap's
variables, every process's ranks join ONE COMM_WORLD; this example
exercises, through the public API only, a collective spanning the
process boundary, p2p between ranks in different processes and RMA
into a remote process's window slice. In one process the world holds
8 virtual ranks and the cross-process legs no-op.

Run on the card::

    python -m ompi_release_tpu_torch.tools.tpurun -n 2 \\
        python -m ompi_release_tpu_torch.examples.unified_world_tpu

or, one command per process (``P`` 0 and 1)::

    OMPITPU_COORDINATOR=127.0.0.1:29500 OMPITPU_PROCESS_ID=P \\
    OMPITPU_NUM_PROCESSES=2 \\
        python -m ompi_release_tpu_torch.examples.unified_world_tpu

``main(device="cpu")`` runs it on the host.
"""

import sys

import numpy as np

import ompi_release_tpu_torch as mpi
from ompi_release_tpu_torch.runtime import ess
from ompi_release_tpu_torch.runtime.runtime import Runtime

#: WORLD's ranks in one process: the JAX package's 8-device test mesh
VIRTUAL_RANKS = 8
#: ranks each process owns when launched (the JAX test's 4 devices a
#: worker)
RANKS_PER_PROCESS = 4


def main(device=None) -> int:
    launched = ess.ESS_FRAMEWORK.select().NAME != "singleton"
    nvirt = RANKS_PER_PROCESS if launched else VIRTUAL_RANKS
    world = mpi.init(cli_args=["--mca", "runtime_virtual_ranks",
                               str(nvirt)], device=device)
    rt = Runtime.current()
    n = world.size
    unified = bool(getattr(rt, "unified", False))
    off = rt.local_rank_offset if unified else 0
    local_n = rt.local_size if unified else n

    # 1. a collective whose result needs every process's contribution
    x = np.stack([np.arange(8, dtype=np.int32) + r
                  for r in range(off, off + local_n)])
    total = world.allreduce(x).cpu().numpy()
    want = sum(np.arange(8, dtype=np.int32) + r for r in range(n))
    np.testing.assert_array_equal(total[0], want)

    if unified and world.spans_processes:
        # 2. p2p across the process boundary (public send/recv)
        if off == 0:
            world.send(np.float32([3.14]), n - 1, tag=9, rank=0)
        if off + local_n == n:
            val, st = world.recv(source=0, tag=9, rank=n - 1)
            assert abs(float(val[0]) - 3.14) < 1e-6
            assert st.source == 0

        # 3. RMA into a slice owned by another process (fence epoch)
        from ompi_release_tpu_torch.osc.window import win_allocate

        win = win_allocate(world, (4,), np.float32)
        win.fence()
        if off == 0:
            win.put(np.full(4, 7.5, np.float32), n - 1)
        win.fence_end()
        if off + local_n == n:
            got = win.read()[(n - 1) - off].cpu().numpy()
            np.testing.assert_array_equal(got, np.full(4, 7.5))
        world.barrier()
        win.free()

    world.barrier()
    print(f"unified world OK (ranks {off}..{off + local_n - 1} of {n})")
    mpi.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
