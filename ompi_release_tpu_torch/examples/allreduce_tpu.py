"""The north-star op: MPI_Allreduce over the ranks.

Port of ``examples/allreduce_tpu.py``. Run on the card:
``python -m ompi_release_tpu_torch.examples.allreduce_tpu`` (8 virtual
ranks on ``cuda:0``).
"""

import sys

import numpy as np

import ompi_release_tpu_torch as mpi

VIRTUAL_RANKS = 8


def main(device=None) -> int:
    from ompi_release_tpu_torch import ops

    world = mpi.init(cli_args=["--mca", "runtime_virtual_ranks",
                               str(VIRTUAL_RANKS)], device=device)
    n = world.size
    x = np.random.default_rng(0).normal(size=(n, 1 << 16)).astype(np.float32)
    out = world.allreduce(x, ops.SUM).cpu().numpy()
    np.testing.assert_allclose(out[0], x.sum(0), rtol=1e-4, atol=1e-4)
    gb = x.nbytes / 1e9
    print(f"allreduce OK: {n} ranks x {x.shape[1]} f32 "
          f"({gb * 1000:.2f} MB total), parity vs numpy verified")
    mpi.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
