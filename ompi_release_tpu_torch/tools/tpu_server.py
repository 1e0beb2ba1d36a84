"""tpu-server — the standalone ``orte-server`` analogue.

The reference's cross-job dynamics need a name server that OUTLIVES
any one job: ``orte-server`` (``orte/tools/orte-server``) hosts the
``pubsub/orte`` name table so two independently-launched mpirun jobs
can MPI_Publish_name / MPI_Lookup_name each other
(``ompi/mca/pubsub/orte/pubsub_orte.c``). A tpurun job's HNP already
serves names for its OWN workers; this tool is the job-independent
server: any process (from any job) connects with a :class:`NameClient`
and publishes/looks up over the same seq-correlated frame protocol.

Beyond names, the server answers a ``metrics`` RPC (TAG_METRICS): the
Prometheus text exposition of every pvar registered in the server
process (``obs/export.py``), so ``tpu_top --metrics host:port`` (or
any scraper speaking the frame protocol) can watch the observability
plane live.

Usage::

    python -m ompi_release_tpu_torch.tools.tpu_server [--port P] [--bind A]
    # prints "tpu-server URI: host:port" then serves until SIGINT

    client = NameClient("hostA", 45123)
    client.publish("my-service", port_str)
    port = client.lookup("my-service", timeout_ms=20000)
    page = client.metrics()          # Prometheus text page
"""

from __future__ import annotations

import argparse
import random
import threading
import time
from typing import List, Optional, Tuple

from ..native import DssBuffer, OobEndpoint
from ..runtime.coordinator import local_addr_toward
from ..runtime.pubsub import (PubsubTable, TAG_LOOKUP, TAG_PUBLISH,
                              TAG_UNPUBLISH)
from ..utils import output
from ..utils.errors import ErrorCode, MPIError

_log = output.stream("tpu-server")

TAG_METRICS = 13  # client->server: Prometheus pvar exposition request
TAG_JOURNAL = 14  # client->server: obs rank-journal dump (JSON)
TAG_SERIES = 15   # client->server: continuous pvar time-series (JSON)


class MetricsPubsubTable(PubsubTable):
    """Name table + three observability RPCs over the same
    seq-correlated reply channel: TAG_METRICS answers with the
    Prometheus text page of every pvar registered in this process;
    TAG_JOURNAL answers with this process's rank journal dump
    (``obs.export.rank_dump`` JSON) — the unit ``tpu-doctor collect``
    fetches and ``tpu-doctor merge`` joins across ranks; TAG_SERIES
    answers with this process's continuous sampler ring
    (``obs.export.series_dump`` JSON) — identity + clock offset +
    time-series points, the live feed ``tpu_top`` renders."""

    def __init__(self, ep) -> None:
        super().__init__(ep)
        self.serve_tags.append(TAG_METRICS)
        self.serve_tags.append(TAG_JOURNAL)
        self.serve_tags.append(TAG_SERIES)

    def handle(self, tag: int, src: int, raw: bytes) -> None:
        if tag not in (TAG_METRICS, TAG_JOURNAL, TAG_SERIES):
            return super().handle(tag, src, raw)
        b = DssBuffer(raw)
        (seq,) = b.unpack_int64()
        if tag == TAG_METRICS:
            from ..obs import export as obs_export

            self._reply(src, seq, True, obs_export.prometheus_text())
        else:
            import json as _json

            from ..obs import export as obs_export

            doc = (obs_export.rank_dump() if tag == TAG_JOURNAL
                   else obs_export.series_dump())
            self._reply(src, seq, True, _json.dumps(doc))


class NameServer:
    """Standalone name-table server: the shared runtime/pubsub.py
    protocol on its own endpoint (no job attached). ``table_factory``
    lets richer residents (``service.daemon.ServiceDaemon``, the
    tenant-multiplexing ``tpu_serviced``) reuse the endpoint/serve
    plumbing with a wider RPC table."""

    def __init__(self, port: int = 0, bind_addr: str = "127.0.0.1",
                 table_factory=None,
                 secret: Optional[bytes] = None) -> None:
        self.ep = OobEndpoint(0, port, bind_addr, secret=secret)
        self._table = (table_factory or MetricsPubsubTable)(self.ep)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._table.serve_loop, args=(self._stop,),
            daemon=True,
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self.ep.port

    def shutdown(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)
        self.ep.close()


class NameClient:
    """A job-independent pubsub client (any process, any job).

    Client ids are random high ints so clients from different jobs
    (which all call their own rank "1") cannot collide on the
    server's per-connection identity. The RPC protocol is the shared
    runtime/pubsub.py helper (same as WorkerAgent's in-job client).
    """

    def __init__(self, host: str, port: int,
                 secret: Optional[bytes] = None) -> None:
        self.client_id = random.randrange(1 << 20, 1 << 30)
        self.ep = OobEndpoint(self.client_id, secret=secret)
        self.ep.connect(0, host, port)
        self._lock = threading.Lock()

    def _rpc(self, tag: int, *fields: str,
             timeout_ms: int = 10_000) -> Tuple[bool, str]:
        from ..runtime.pubsub import pubsub_rpc

        return pubsub_rpc(self.ep, self._lock, self, tag, *fields,
                          timeout_ms=timeout_ms)

    def publish(self, service: str, port: str,
                ttl_s: Optional[float] = None) -> None:
        """Publish a name; ``ttl_s`` bounds its lifetime server-side
        (the entry is pruned by the serve loop after expiry — a crashy
        client's names cannot outlive it by more than the TTL). The
        TTL rides as an optional trailing frame field, so old servers
        simply ignore it."""
        fields = [service, port]
        if ttl_s is not None:
            fields.append(str(int(float(ttl_s) * 1000)))
        ok, msg = self._rpc(TAG_PUBLISH, *fields)
        if not ok:
            raise MPIError(ErrorCode.ERR_NAME,
                           f"publish '{service}': {msg}")

    def lookup(self, service: str, *, timeout_ms: int = 10_000) -> str:
        ok, value = self._rpc(TAG_LOOKUP, service, str(timeout_ms),
                              timeout_ms=timeout_ms)
        if not ok:
            raise MPIError(ErrorCode.ERR_NAME,
                           f"lookup '{service}': {value}")
        return value

    def unpublish(self, service: str) -> None:
        ok, _ = self._rpc(TAG_UNPUBLISH, service)
        if not ok:
            raise MPIError(ErrorCode.ERR_NAME,
                           f"unpublish '{service}': not published")

    def metrics(self, *, timeout_ms: int = 10_000) -> str:
        """Prometheus text exposition of the server process's pvars."""
        ok, text = self._rpc(TAG_METRICS, timeout_ms=timeout_ms)
        if not ok:
            raise MPIError(ErrorCode.ERR_NAME, f"metrics: {text}")
        return text

    def journal(self, *, timeout_ms: int = 10_000) -> dict:
        """The server process's obs rank-journal dump (spans + rank
        identity + clock offset) — tpu-doctor's remote collect path."""
        import json as _json

        ok, text = self._rpc(TAG_JOURNAL, timeout_ms=timeout_ms)
        if not ok:
            raise MPIError(ErrorCode.ERR_NAME, f"journal: {text}")
        return _json.loads(text)

    def series(self, *, timeout_ms: int = 10_000) -> dict:
        """The server process's continuous pvar time-series ring
        (``{"meta": ..., "points": [...]}``) — the live feed behind
        ``tpu_top`` and the doctor's series merge."""
        import json as _json

        ok, text = self._rpc(TAG_SERIES, timeout_ms=timeout_ms)
        if not ok:
            raise MPIError(ErrorCode.ERR_NAME, f"series: {text}")
        return _json.loads(text)

    def close(self) -> None:
        self.ep.close()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu-server",
        description="Standalone cross-job name server (orte-server "
                    "analogue)")
    ap.add_argument("--port", type=int, default=0,
                    help="listen port (0 = ephemeral)")
    ap.add_argument("--bind", default="0.0.0.0",
                    help="listen address (default: all interfaces)")
    args = ap.parse_args(argv)
    srv = NameServer(args.port, args.bind)
    # advertise an address clients can actually dial: the outward
    # interface only when listening on all interfaces, else the bound
    # address itself
    host = (local_addr_toward("192.0.2.1") if args.bind == "0.0.0.0"
            else args.bind)
    print(f"tpu-server URI: {host}:{srv.port}", flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        srv.shutdown()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
