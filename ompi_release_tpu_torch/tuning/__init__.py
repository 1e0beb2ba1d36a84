"""Persistent per-topology tuning: the coll/tuned decision tables made
fleet-durable (counterpart of ``ompi_release_tpu/tuning``).

:mod:`.db` stores versioned dynamic-rule files keyed by a topology
fingerprint (hosts, procs-per-host, link classes, P), so a fleet never
re-pays a tuning sweep; :mod:`.retune` watches the series plane for
sustained slow links and applies re-measured rules through a cvar write
(which bumps the MCA write generation, so frozen plans re-plan at the
next fire, never mid-schedule).
"""

from . import db  # noqa: F401  (registers the coll_tuning_db_dir cvar)
