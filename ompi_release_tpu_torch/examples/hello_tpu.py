"""hello_c.c analogue: the process reports its identity.

Port of ``examples/hello_tpu.py``. Run on the card:
``python -m ompi_release_tpu_torch.examples.hello_tpu``.
"""

import sys

import ompi_release_tpu_torch as mpi


def main(device=None) -> int:
    world = mpi.init(device=device)
    rt = mpi.runtime.runtime.Runtime.current()
    pi = rt.bootstrap.get("process_index", 0)
    pc = rt.bootstrap.get("process_count", 1)
    print(f"Hello, world, I am process {pi} of {pc} "
          f"(world comm size {world.size})")
    mpi.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
