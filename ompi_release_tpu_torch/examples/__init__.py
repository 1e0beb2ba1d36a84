"""Ports of the JAX package's examples (``examples/*_tpu.py``).

Each module has a ``main(device=None)`` that brings the runtime up on
``device`` (``cuda:0`` by default), runs, finalizes and returns an exit
code; nothing runs at import. Run one as
``python -m ompi_release_tpu_torch.examples.ring_tpu`` (on the card) or
call ``main(device="cpu")``.
"""
