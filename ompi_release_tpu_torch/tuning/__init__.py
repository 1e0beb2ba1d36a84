"""Persistent per-topology tuning: the coll/tuned decision tables made
fleet-durable (counterpart of ``ompi_release_tpu/tuning``).

:mod:`.db` stores versioned dynamic-rule files keyed by a topology
fingerprint (hosts, procs-per-host, link classes, P), so a fleet never
re-pays a tuning sweep. Online re-tuning (``retune``) is not ported.
"""

from . import db  # noqa: F401  (registers the coll_tuning_db_dir cvar)
