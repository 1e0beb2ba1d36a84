"""Process liveness helpers shared by the job tools (tpu-ps/top,
tpu-clean, tpu-migrate discovery)."""

from __future__ import annotations

import os


def pid_alive(pid: int) -> bool:
    """True if ``pid`` plausibly names a LIVE process.

    ``pid <= 0`` is never alive — ``os.kill(0, ...)`` / ``kill(-1,
    ...)`` signal whole process groups and "succeed", which would
    classify a malformed contact file as an immortal job. Booleans
    are rejected for the same reason: JSON ``true`` satisfies
    ``isinstance(x, int)`` and would probe pid 1 (init — always
    alive). ``PermissionError`` means alive-but-not-ours: the owner's
    debris is not ours to reap."""
    if isinstance(pid, bool) or pid <= 0:
        return False
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    except OSError:
        return False
