"""tpu-serviced — the resident multi-tenant collective daemon.

``tpu_server`` is the job-independent *name* server (the orte-server
role); this daemon is the next stage of that idea:
a resident process that many independently launched jobs ATTACH to as
**tenants** of one fabric. It serves, over the same seq-correlated
OOB frame protocol:

- everything ``tpu_server`` serves (publish/lookup/unpublish names +
  the metrics/journal/series observability RPCs);
- ``TAG_TENANT`` — the tenant control plane: ``admit`` (admission
  control against rank/lane capacity; returns the tenant id, its
  private cid band, its lease token), ``renew`` (heartbeat + stats
  report), ``release`` (graceful exit), ``fail`` (a tenant reporting
  its own rank death — eviction with the episode named);
- ``TAG_TENANTS`` — the per-tenant fabric view ``tpu_top --tenants``
  renders: who is burning the fabric (coll/s, MB/s, lane share, HOL
  wait per tenant), lease ages, recent evictions.

Tenant-scoped pubsub: every name published through the daemon is
stamped with its publisher's client id (see ``runtime/pubsub.py``);
eviction — explicit, or by lease expiry in the serve loop's
``prune()`` — drops the tenant's names, revokes its cid band through
the real ULFM machinery, and clears its sentinel chains. Other
tenants and the daemon itself never notice: the kill-mid-allreduce
job test pins exactly that.

Usage::

    python -m ompi_release_tpu_torch.service.daemon [--port P] [--bind A]
        [--capacity-ranks N] [--capacity-lanes N] [--lease SECS]

    client = ServiceClient(host, port)
    grant = client.admit("trainer-a", ranks=8, qos="latency")
    ...
    client.renew(grant["tid"], grant["token"],
                 stats={"coll_s": 120.0, "mb_s": 85.0})
    client.release(grant["tid"], grant["token"])
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List, Optional

from ..native import DssBuffer
from ..runtime.coordinator import local_addr_toward
from ..utils import output
from ..utils.errors import ErrorCode, MPIError
from ..tools.tpu_server import MetricsPubsubTable, NameClient, NameServer
from .tenant import TenantRegistry

_log = output.stream("tpu-serviced")

#: tenant control RPC (admit/renew/release/fail as one JSON doc)
TAG_TENANT = 16
#: per-tenant fabric view (the tpu_top --tenants feed)
TAG_TENANTS = 17

#: env var carrying the SERVICE-plane auth secret. Deliberately
#: distinct from ``OMPITPU_JOB_SECRET``: the daemon is shared by many
#: jobs from different trust domains, so a tenant must never present
#: (or be asked for) another job's private control-plane secret —
#: inside a tpurun worker the ambient job secret would leak into a
#: default-constructed endpoint and the daemon would refuse it.
SERVICE_SECRET_ENV = "OMPITPU_SERVICE_SECRET"


def service_secret() -> bytes:
    """The shared service-plane secret (empty = unauthenticated)."""
    import os

    return os.environ.get(SERVICE_SECRET_ENV, "").encode()


class ServiceTable(MetricsPubsubTable):
    """The daemon's RPC table: names + observability + the tenant
    control plane, one serve loop. ``prune()`` — already run every
    serve iteration by the shared pubsub plumbing — additionally
    sweeps expired leases, so silent tenant death is detected by the
    very loop that serves live ones."""

    def __init__(self, ep, registry: TenantRegistry) -> None:
        super().__init__(ep)
        self.registry = registry
        self.serve_tags.append(TAG_TENANT)
        self.serve_tags.append(TAG_TENANTS)
        # eviction drops the tenant's published names by owner
        # identity — a dead tenant's stale names must never resolve
        # for the next tenant
        registry.add_evict_listener(
            lambda t, reason: self.evict_owner(t.owner))

    def prune(self) -> None:
        super().prune()
        self.registry.sweep()

    def handle(self, tag: int, src: int, raw: bytes) -> None:
        if tag not in (TAG_TENANT, TAG_TENANTS):
            return super().handle(tag, src, raw)
        b = DssBuffer(raw)
        (seq,) = b.unpack_int64()
        if tag == TAG_TENANTS:
            self._reply(src, seq, True,
                        json.dumps(self.registry.doc()))
            return
        try:
            doc = json.loads(b.unpack_string())
            op = str(doc.get("op", ""))
            out = self._tenant_op(op, doc, src)
        except MPIError as e:
            self._reply(src, seq, False, f"{e.code.name}: {e}")
            return
        except Exception as e:
            self._reply(src, seq, False, f"malformed tenant rpc: {e}")
            return
        self._reply(src, seq, True, json.dumps(out))

    def _tenant_op(self, op: str, doc: Dict[str, Any],
                   src: int) -> Dict[str, Any]:
        reg = self.registry
        if op == "admit":
            t = reg.admit(doc.get("name", ""),
                          int(doc.get("ranks", 0)),
                          qos=str(doc.get("qos", "best_effort")),
                          lanes=int(doc.get("lanes", 1)),
                          owner=src,
                          lease_s=doc.get("lease_s"))
            lo, hi = t.band
            return {"tid": t.tid, "token": t.token, "band": [lo, hi],
                    "qos": t.qos, "lease_s": t.lease_s}
        if op == "renew":
            t = reg.renew(int(doc.get("tid", -1)),
                          str(doc.get("token", "")),
                          stats=doc.get("stats"))
            return {"tid": t.tid, "expires_in_s":
                    round(t.expires_at - time.monotonic(), 3)}
        if op == "release":
            t = reg.release(int(doc.get("tid", -1)),
                            str(doc.get("token", "")))
            return {"tid": t.tid, "state": t.state}
        if op == "fail":
            t = reg.fail(int(doc.get("tid", -1)),
                         str(doc.get("token", "")),
                         reason=str(doc.get("reason",
                                            "rank failure reported")))
            return {"tid": t.tid, "state": t.state,
                    "evict_reason": t.evict_reason}
        raise MPIError(ErrorCode.ERR_ARG,
                       f"unknown tenant op {op!r}")


class ServiceDaemon(NameServer):
    """The resident daemon: a :class:`~..tools.tpu_server.NameServer`
    whose table is the tenant-multiplexing :class:`ServiceTable`."""

    def __init__(self, port: int = 0, bind_addr: str = "127.0.0.1", *,
                 capacity_ranks: int = 256, capacity_lanes: int = 64,
                 lease_s: float = 30.0,
                 secret: Optional[bytes] = None) -> None:
        self.registry = TenantRegistry(
            capacity_ranks=capacity_ranks,
            capacity_lanes=capacity_lanes, lease_s=lease_s)
        super().__init__(
            port, bind_addr,
            table_factory=lambda ep: ServiceTable(ep, self.registry),
            secret=service_secret() if secret is None else secret)


class ServiceClient(NameClient):
    """A tenant job's handle on the daemon: the NameClient pubsub RPCs
    plus the tenant control plane. One client per job controller; the
    client id doubles as the tenant's owner identity (name eviction).

    Authenticates with the SERVICE secret (``OMPITPU_SERVICE_SECRET``),
    never the ambient per-job ``OMPITPU_JOB_SECRET`` a tpurun worker
    inherits — the daemon sits outside any one job's trust domain."""

    def __init__(self, host: str, port: int,
                 secret: Optional[bytes] = None) -> None:
        super().__init__(
            host, port,
            secret=service_secret() if secret is None else secret)

    def _tenant_rpc(self, doc: Dict[str, Any], *,
                    timeout_ms: int = 10_000) -> Dict[str, Any]:
        ok, text = self._rpc(TAG_TENANT, json.dumps(doc),
                             timeout_ms=timeout_ms)
        if not ok:
            code = ErrorCode.ERR_OTHER
            for c in (ErrorCode.ERR_NO_MEM, ErrorCode.ERR_NAME,
                      ErrorCode.ERR_ARG):
                if text.startswith(c.name):
                    code = c
                    break
            raise MPIError(code, f"tenant rpc "
                                 f"{doc.get('op')}: {text}")
        return json.loads(text)

    def admit(self, name: str, ranks: int, *,
              qos: str = "best_effort", lanes: int = 1,
              lease_s: Optional[float] = None) -> Dict[str, Any]:
        doc: Dict[str, Any] = {"op": "admit", "name": name,
                               "ranks": int(ranks), "qos": qos,
                               "lanes": int(lanes)}
        if lease_s is not None:
            doc["lease_s"] = float(lease_s)
        return self._tenant_rpc(doc)

    def renew(self, tid: int, token: str,
              stats: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        return self._tenant_rpc({"op": "renew", "tid": int(tid),
                                 "token": token, "stats": stats or {}})

    def release(self, tid: int, token: str) -> Dict[str, Any]:
        return self._tenant_rpc({"op": "release", "tid": int(tid),
                                 "token": token})

    def fail(self, tid: int, token: str,
             reason: str = "rank failure reported") -> Dict[str, Any]:
        return self._tenant_rpc({"op": "fail", "tid": int(tid),
                                 "token": token, "reason": reason})

    def tenants(self, *, timeout_ms: int = 10_000) -> Dict[str, Any]:
        """The TAG_TENANTS fabric view (tpu_top --tenants feed)."""
        ok, text = self._rpc(TAG_TENANTS, timeout_ms=timeout_ms)
        if not ok:
            raise MPIError(ErrorCode.ERR_NAME, f"tenants: {text}")
        return json.loads(text)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu-serviced",
        description="Resident multi-tenant collective daemon "
                    "(names + admission control + per-tenant view)")
    ap.add_argument("--port", type=int, default=0,
                    help="listen port (0 = ephemeral)")
    ap.add_argument("--bind", default="0.0.0.0",
                    help="listen address (default: all interfaces)")
    ap.add_argument("--capacity-ranks", type=int, default=256,
                    help="total ranks admissible across tenants")
    ap.add_argument("--capacity-lanes", type=int, default=64,
                    help="total wire lanes admissible across tenants")
    ap.add_argument("--lease", type=float, default=30.0,
                    help="tenant lease seconds (heartbeat deadline)")
    args = ap.parse_args(argv)
    srv = ServiceDaemon(args.port, args.bind,
                        capacity_ranks=args.capacity_ranks,
                        capacity_lanes=args.capacity_lanes,
                        lease_s=args.lease)
    host = (local_addr_toward("192.0.2.1") if args.bind == "0.0.0.0"
            else args.bind)
    print(f"tpu-serviced URI: {host}:{srv.port}", flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        srv.shutdown()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
