"""OOB stress on the port's ``native/bindings.py`` endpoint, held to
``tests/test_oob_stress.py`` (the ``orte/test/system/oob_stress.c``
analogue): many frames, many tags, concurrent senders, relay routing,
mixed payload sizes — zero loss, zero corruption, per-tag order under
load. The many-senders case also runs with the JAX package's endpoints
as the senders into the port's root (the two builds of the same C
sources speak one wire).
"""

import hashlib
import threading

import pytest

from ompi_release_tpu_torch.native import OobEndpoint
from ompi_release_tpu_torch.utils.errors import MPIError


def _sender_ep(lib, nid):
    if lib == "jax":
        from ompi_release_tpu.native import OobEndpoint as JaxEndpoint

        return JaxEndpoint(nid, secret=b"")
    return OobEndpoint(nid, secret=b"")


def _payload(sender: int, seq: int, size: int) -> bytes:
    head = f"{sender}:{seq}:".encode()
    body = hashlib.sha256(head).digest()
    return (head + body * (size // 32 + 1))[:max(size, len(head))]


class TestOobStress:
    @pytest.mark.parametrize("lib", ["port", "jax"])
    def test_many_senders_many_tags_no_loss(self, lib):
        """4 senders x 50 frames x 3 tags into one root concurrently:
        every frame arrives intact, per-(sender, tag) order holds
        (the OOB guarantees FIFO per connection per tag)."""
        n_senders, n_frames = 4, 50
        tags = (11, 12, 13)
        root = OobEndpoint(0, secret=b"")
        senders = []
        try:
            for s in range(1, n_senders + 1):
                ep = _sender_ep(lib, s)
                ep.connect(0, "127.0.0.1", root.port)
                senders.append(ep)

            def blast(idx: int, ep) -> None:
                for seq in range(n_frames):
                    tag = tags[seq % len(tags)]
                    ep.send(0, tag, _payload(idx + 1, seq,
                                             64 * (1 + seq % 5)))

            threads = [
                threading.Thread(target=blast, args=(i, ep))
                for i, ep in enumerate(senders)
            ]
            for t in threads:
                t.start()
            got: dict = {}
            total = n_senders * n_frames
            for _ in range(total):
                # drain round-robin across tags so no tag starves
                frame = None
                for tag in tags:
                    try:
                        frame = root.recv(tag=tag, timeout_ms=50)
                        break
                    except MPIError:
                        continue
                if frame is None:
                    frame = root.recv(tag=-1, timeout_ms=10_000)
                src, tag, raw = frame
                head, seq_s, _ = raw.split(b":", 2)
                assert int(head) == src  # sender id embedded = frame src
                got.setdefault((src, tag), []).append(int(seq_s))
            for t in threads:
                t.join()
            assert sum(len(v) for v in got.values()) == total
            # exact per-key sequence: pins zero loss AND zero
            # duplication (count+sortedness alone would admit a dup
            # masking a drop)
            for s_id in range(1, n_senders + 1):
                for ti, tag in enumerate(tags):
                    expect = [q for q in range(n_frames)
                              if q % len(tags) == ti]
                    assert got.get((s_id, tag), []) == expect, (
                        f"sender {s_id} tag {tag}: "
                        f"{got.get((s_id, tag))} != {expect}"
                    )
        finally:
            root.close()
            for ep in senders:
                ep.close()

    def test_relay_routing_under_load(self):
        """100 frames each direction through a middle relay node
        (A - M - C): routed delivery with zero loss and intact
        payloads (the tree-xcast data path under stress)."""
        a, mid, c = (OobEndpoint(i, secret=b"") for i in range(3))
        try:
            a.connect(1, "127.0.0.1", mid.port)
            c.connect(1, "127.0.0.1", mid.port)
            a.add_route(2, 1)
            c.set_default_route(1)
            n = 100

            def down() -> None:
                for seq in range(n):
                    a.send(2, 21, _payload(0, seq, 256))

            def up() -> None:
                for seq in range(n):
                    c.send(0, 22, _payload(2, seq, 1024))

            ts = [threading.Thread(target=down),
                  threading.Thread(target=up)]
            for t in ts:
                t.start()
            down_seqs, up_seqs = [], []
            for _ in range(n):
                _, _, raw = c.recv(tag=21, timeout_ms=10_000)
                down_seqs.append(int(raw.split(b":", 2)[1]))
            for _ in range(n):
                _, _, raw = a.recv(tag=22, timeout_ms=10_000)
                up_seqs.append(int(raw.split(b":", 2)[1]))
            for t in ts:
                t.join()
            assert down_seqs == list(range(n))
            assert up_seqs == list(range(n))
        finally:
            for e in (a, mid, c):
                e.close()

    def test_mixed_sizes_integrity(self):
        """Payloads from 1 B to 4 MiB interleaved on one connection:
        every byte accounted for (length-prefixed framing under
        pressure)."""
        a, b = OobEndpoint(0, secret=b""), OobEndpoint(1, secret=b"")
        try:
            b.connect(0, "127.0.0.1", a.port)
            sizes = [1, 33, 4096, 65_536, 1 << 20, 4 << 20, 7, 512]
            blobs = [bytes([i % 251]) * s for i, s in enumerate(sizes)]
            for blob in blobs:
                b.send(0, 31, blob)
            for expect in blobs:
                _, _, raw = a.recv(tag=31, timeout_ms=10_000)
                assert raw == expect
        finally:
            a.close()
            b.close()
