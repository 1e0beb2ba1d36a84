"""Ports of the JAX package's examples (``examples/*_tpu.py``): hello,
ring, allreduce, connectivity, hello_oshmem, ring_oshmem,
oshmem_reduction and unified_world.

Each module has a ``main(device=None)`` that brings the runtime up on
``device`` (``cuda:0`` by default), runs, finalizes and returns an exit
code; nothing runs at import. Run one as
``python -m ompi_release_tpu_torch.examples.ring_tpu`` (on the card) or
call ``main(device="cpu")``. ``unified_world_tpu`` also runs across
processes, under ``tools.tpurun -n 2`` or started by hand with the
distributed bootstrap's variables (``OMPITPU_COORDINATOR``,
``OMPITPU_PROCESS_ID``, ``OMPITPU_NUM_PROCESSES``).
"""
