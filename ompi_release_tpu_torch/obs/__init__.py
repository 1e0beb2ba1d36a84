"""Always-on observability plane — journal, skew metrics, exporters.

The reference instruments itself at every layer (MPI_T pvars, PERUSE
events, PMPI interposition, orte-top sampling); this package is the
TPU-native unification: emit points *inside* the framework (coll
driver, vcoll edge, pml, btl, request wait, sharded IO) write spans
into one ring-buffer journal (:mod:`obs.journal`) and bump per-op /
per-BTL histogram, aggregate, and rank-skew pvars
(:mod:`obs.skew`), all readable through the existing MPI_T handles
(``mca/mpit.py``) and exportable as Chrome/Perfetto ``trace_event``
JSON, JSONL, or Prometheus text (:mod:`obs.export`).

Switching on (any one of):

  - env var ``OMPI_TPU_OBS=1`` (read at import)
  - MCA cvar ``obs_enable`` (``OMPITPU_MCA_obs_enable=1``)
  - :func:`enable` at runtime

The hot-path cost when off is a single module-attribute check
(``obs.enabled``) per instrumented call site — no locks, no clock
reads, no allocation. ``python -m ompi_release_tpu_torch.obs --selftest``
exercises every pvar class and exporter round-trip, device-free.
"""

from __future__ import annotations

import os

from ..mca import pvar as _pvar
from ..mca import var as _var
from . import journal as journal_mod
from .journal import Journal, Span, flow_id  # noqa: F401  (public API)

#: THE hot-path gate: emit points check ``obs.enabled`` and do nothing
#: else when False. One module attribute, mutated only by
#: enable()/disable().
enabled: bool = False

#: process-global journal (identity is stable across enable/resize)
journal = journal_mod.JOURNAL


def register_vars() -> None:
    _var.register(
        "obs_enable", "bool", False,
        "Enable the observability plane (event journal + per-op "
        "histogram/skew pvars) at import — same effect as "
        "OMPI_TPU_OBS=1 or obs.enable()",
    )
    _var.register(
        "obs_journal_size", "size", journal_mod.DEFAULT_SIZE,
        "Ring-buffer event-journal capacity in spans (oldest spans are "
        "overwritten); applied when obs.enable() runs",
    )


register_vars()  # idempotent; cvars must exist before any enable()

_pvar.PVARS.register(
    "obs_journal_events", _pvar.PvarClass.COUNTER,
    "spans ever recorded in the obs event journal",
    getter=lambda: journal.total_recorded,
)
_pvar.PVARS.register(
    "obs_journal_dropped", _pvar.PvarClass.COUNTER,
    "journal spans lost to ring wrap (raise obs_journal_size)",
    getter=lambda: journal.dropped,
)


#: cross-controller clock alignment (runtime/coordinator.py ping-pong
#: estimator): offset_s maps THIS process's perf_counter timebase into
#: the HNP's; tpu-doctor subtracts per-rank offsets to merge journals
#: onto one timeline. None = never estimated (singleton, or no HNP).
_clock_state: dict = {"offset_s": None, "rtt_s": None, "source": None}


def rank_identity() -> dict:
    """Best-effort process identity (pid, pidx, world-rank span) — THE
    shared derivation behind both the postmortem's ``rank`` block and
    the finalize dump's ``meta``, so the doctor's two input formats
    can never drift. Never raises (dumps run from signal handlers and
    half-initialized runtimes)."""
    import os as _os

    ident = {"pid": _os.getpid(), "pidx": 0, "rank_offset": 0,
             "local_size": 0}
    try:
        from ..runtime.runtime import Runtime

        rt = Runtime._instance
        if rt is not None and rt.bootstrap:
            ident["pidx"] = int(rt.bootstrap.get("process_index", 0))
            ident["rank_offset"] = int(rt.local_rank_offset)
            ident["local_size"] = int(
                rt.local_size or len(rt.endpoints or ())
            )
    except Exception:
        pass
    return ident


def set_clock(offset_s: float, rtt_s: float, source: str = "oob") -> None:
    _clock_state.update(offset_s=offset_s, rtt_s=rtt_s, source=source)


def clock_offset():
    return _clock_state["offset_s"]


def enable(size: int = None) -> None:
    """Turn the plane on; the journal takes ``obs_journal_size`` (or
    the explicit ``size``) without losing already-buffered spans."""
    global enabled
    if size is None:
        size = int(_var.get("obs_journal_size", journal_mod.DEFAULT_SIZE))
    if int(size) != journal.size:
        journal.resize(int(size))
    enabled = True
    from . import sentinel as _sentinel
    from . import watchdog as _wd

    _wd.refresh(True)
    _sentinel.refresh(True)
    # obs turned on AFTER mpi.init() (Runtime.init only installs the
    # flight-recorder signal handlers when obs was already on): the
    # documented `kill -USR1` dump must work for mid-run enables too.
    # Only when a runtime is live — a bare tracing-unit enable() in a
    # host process (pytest, bench) must not hijack its faulthandler —
    # so probe sys.modules rather than importing the runtime (a live
    # runtime implies the module is imported; a light obs import must
    # not drag it in).
    try:
        import sys as _sys

        _rt_mod = _sys.modules.get("ompi_release_tpu_torch.runtime.runtime")
        rt = (_rt_mod.Runtime._instance
              if _rt_mod is not None else None)
        if rt is not None and rt.initialized and not rt.finalized:
            _wd.install_signal_handlers()
    except Exception:
        pass


def disable() -> None:
    global enabled
    enabled = False
    from . import sentinel as _sentinel
    from . import watchdog as _wd

    _wd.refresh(False)
    _sentinel.refresh(False)


def is_enabled() -> bool:
    return enabled


def record(op: str, layer: str, t_start: float, dt: float,
           nbytes: int = 0, peer: int = -1, comm_id: int = -1,
           flow: int = 0, flow_side: str = "", name: str = "") -> Span:
    """Emit-point helper: journal one span. Callers gate on
    ``obs.enabled`` themselves so the off cost stays one attr check."""
    return journal.record(op, layer, t_start, dt, nbytes, peer, comm_id,
                          flow, flow_side, name)


# the always-on switch: env var wins, then the MCA cvar
if (os.environ.get("OMPI_TPU_OBS", "").strip().lower()
        in ("1", "true", "yes", "on")
        or bool(_var.get("obs_enable", False))):
    enable()

# convenience: obs.export.dump_chrome_trace(...), obs.skew, the stall
# watchdog, the continuous sampler, the collective contract sentinel,
# the compiled-fire flight recorder, and the doctor merge — imported
# last so their journal/pvar imports see a fully-initialized package
# (sampler import also registers the obs_sample_* cvars and the
# obs_series_points / obs_sample_overhead_seconds pvars; sentinel
# registers obs_sentinel and the sentinel_ops_hashed /
# sentinel_mismatches pvars; ledger registers obs_ledger_size and the
# ledger_records / ledger_dropped pvars)
from . import export, ledger, sampler, sentinel  # noqa: E402,F401
from . import skew, watchdog  # noqa: E402,F401
