"""In-process simulation harnesses — run the real stack without
processes or devices.

Two simulators share the ``_XchgAdapter`` exchange contract of
``coll/hier_schedules.py`` (one call posts all of a schedule round's
sends, then reaps its receives), so the same unmodified schedule code
runs under either:

- :mod:`.lockstep` — the minimal thread-per-process FIFO world the
  bitwise-parity matrix of ``tests/test_hier_schedules.py`` drives:
  no clock, no fabric model, just the transport contract. Milliseconds
  per (P, op, dtype, algorithm) cell.
- :mod:`.fleet_sim` — the simulated-fleet scale harness: hundreds to
  thousands of ranks over a virtual wire with per-link latency /
  bandwidth / loss, host topologies, a deterministic virtual clock,
  per-rank metrology (rounds, messages, inter-host bytes), and the
  real ``ft/ulfm.py`` failure picture + ``obs/sentinel.py`` chain
  hashing driven per simulated rank.
- :mod:`.scenarios` — seeded chaos scripts over the fleet sim
  (cascading rank deaths, network partitions, slow-NIC stragglers)
  that replay deterministically and roll the survivors through the
  ULFM revoke -> rebuild recovery shape.

Import-light by design (numpy only, no jax): the harness must bring
up a 4096-rank virtual fleet in well under a second.
"""

from .lockstep import SimWorld, SimXchg, simulate  # noqa: F401
