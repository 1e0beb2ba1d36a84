"""The port's native bindings (``ompi_release_tpu_torch/native``) held
against ``tests/test_native.py``: DSS, the routed and authenticated
OOB, the multi-process coordinator, the name server and the closed
endpoint — plus wire interop with the JAX package (both load the same
C sources, so a frame packed by one unpacks in the other) and the
port's own build directory."""

import hashlib
import json
import os
import subprocess
import sys
import textwrap

import pytest

from ompi_release_tpu import native as jnative
from ompi_release_tpu_torch import native as tnative
from ompi_release_tpu_torch.native import DssBuffer, OobEndpoint
from ompi_release_tpu_torch.runtime.coordinator import HnpCoordinator
from ompi_release_tpu_torch.utils.errors import MPIError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestDss:
    def test_roundtrip_all_types(self):
        b = DssBuffer()
        b.pack_int64([1, -2, 3]).pack_string("héllo").pack_double(
            [3.25, -0.5]).pack_bytes(b"\x00\xff\x80")
        r = DssBuffer(b.tobytes())
        assert r.peek() == ("int64", 3)
        assert r.unpack_int64() == [1, -2, 3]
        assert r.unpack_string() == "héllo"
        assert r.unpack_double() == [3.25, -0.5]
        assert r.unpack_bytes() == b"\x00\xff\x80"
        assert r.peek() is None

    def test_type_mismatch_raises_and_preserves_cursor(self):
        b = DssBuffer()
        b.pack_int64(7).pack_string("x")
        r = DssBuffer(b.tobytes())
        with pytest.raises(MPIError):
            r.unpack_string()
        assert r.unpack_int64() == [7]

    def test_truncated_buffer_raises(self):
        b = DssBuffer()
        b.pack_int64([1, 2, 3, 4])
        with pytest.raises(MPIError):
            DssBuffer(b.tobytes()[:10]).unpack_int64()

    def test_rewind(self):
        raw = DssBuffer(DssBuffer().pack_string("again").tobytes())
        assert raw.unpack_string() == "again"
        raw.rewind()
        assert raw.unpack_string() == "again"

    @pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
    def test_bytes_identical_across_packages(self, direction):
        """One wire format: the port's frames are the JAX package's,
        byte for byte, and unpack in either."""
        def pack(mod):
            return (mod.DssBuffer().pack_int64([5, -6])
                    .pack_string("card").pack_double([0.125])
                    .pack_bytes(b"\x01\x02").tobytes())

        assert pack(tnative) == pack(jnative)
        src, dst = ((tnative, jnative) if direction == "port_to_jax"
                    else (jnative, tnative))
        r = dst.DssBuffer(pack(src))
        assert r.unpack_int64() == [5, -6]
        assert r.unpack_string() == "card"
        assert r.unpack_double() == [0.125]
        assert r.unpack_bytes() == b"\x01\x02"

    def test_user_tag_base_and_secret_env_match(self):
        assert tnative.USER_TAG_BASE == jnative.USER_TAG_BASE == 100
        from ompi_release_tpu.native.bindings import SECRET_ENV

        assert tnative.SECRET_ENV == SECRET_ENV


class TestOob:
    def test_direct_send_recv(self):
        a, b = OobEndpoint(0), OobEndpoint(1)
        try:
            b.connect(0, "127.0.0.1", a.port)
            b.send(0, 7, b"hi root")
            assert a.recv(tag=7, timeout_ms=5000) == (1, 7, b"hi root")
            a.send(1, 8, b"hi leaf")
            assert b.recv(tag=8, timeout_ms=5000)[2] == b"hi leaf"
        finally:
            a.close()
            b.close()

    def test_tree_routing_three_hop(self):
        a, mid, c = OobEndpoint(0), OobEndpoint(1), OobEndpoint(2)
        try:
            a.connect(1, "127.0.0.1", mid.port)
            c.connect(1, "127.0.0.1", mid.port)
            a.add_route(2, 1)
            c.set_default_route(1)
            a.send(2, 42, b"down")
            assert c.recv(tag=42, timeout_ms=5000)[2] == b"down"
            c.send(0, 43, b"up")
            assert a.recv(tag=43, timeout_ms=5000)[2] == b"up"
        finally:
            for e in (a, mid, c):
                e.close()

    def test_large_payload_and_tag_selectivity(self):
        a, b = OobEndpoint(0), OobEndpoint(1)
        try:
            b.connect(0, "127.0.0.1", a.port)
            big = bytes(range(256)) * 8192
            b.send(0, 2, b"second")
            b.send(0, 1, big)
            assert a.recv(tag=1, timeout_ms=5000)[2] == big
            assert a.recv(tag=2, timeout_ms=5000)[2] == b"second"
        finally:
            a.close()
            b.close()

    def test_auth_wrong_secret_refused_right_secret_works(self):
        srv = OobEndpoint(0, secret=b"right")
        try:
            bad = OobEndpoint(1, secret=b"wrong")
            try:
                try:
                    bad.connect(0, "127.0.0.1", srv.port)
                    bad.send(0, 5, b"x")
                except MPIError:
                    pass
                with pytest.raises(MPIError):
                    srv.recv(tag=5, timeout_ms=500)
            finally:
                bad.close()
            good = OobEndpoint(2, secret=b"right")
            try:
                good.connect(0, "127.0.0.1", srv.port)
                good.send(0, 6, b"authed")
                assert srv.recv(tag=6, timeout_ms=5000) == (2, 6, b"authed")
            finally:
                good.close()
        finally:
            srv.close()

    def test_recv_timeout(self):
        a = OobEndpoint(0)
        try:
            with pytest.raises(MPIError):
                a.recv(tag=9, timeout_ms=100)
        finally:
            a.close()

    def test_port_and_jax_endpoints_talk(self):
        """An authenticated link between a port endpoint and a JAX
        package endpoint carries frames both ways."""
        srv = jnative.OobEndpoint(0, secret=b"s3")
        cli = OobEndpoint(1, secret=b"s3")
        try:
            cli.connect(0, "127.0.0.1", srv.port)
            cli.send(0, 120, b"from the port")
            assert srv.recv(tag=120, timeout_ms=5000) == (
                1, 120, b"from the port")
            srv.send(1, 121, b"from jax")
            assert cli.recv(tag=121, timeout_ms=5000)[2] == b"from jax"
        finally:
            cli.close()
            srv.close()


WORKER_SCRIPT = textwrap.dedent("""
    import sys, json
    sys.path.insert(0, %r)
    from ompi_release_tpu_torch.runtime.coordinator import WorkerAgent

    rank, port = int(sys.argv[1]), int(sys.argv[2])
    n = 4
    agent = WorkerAgent(rank, "127.0.0.1", port)
    cards = agent.run_modex({"host": f"worker{rank}", "devices": rank})
    assert cards[rank]["devices"] == rank, cards
    agent.setup_tree(n, cards[1:])
    agent.barrier()
    payload = agent.recv_xcast()
    agent.barrier()
    print(json.dumps({"rank": rank, "n_cards": len(cards),
                      "xcast": payload.decode()}))
    agent.wait_fin()
""" % REPO)


class TestCoordinator:
    @pytest.mark.parametrize("hnp_pkg", ["port", "jax"])
    def test_multiprocess_modex_barrier_xcast(self, tmp_path, hnp_pkg):
        """4 real processes: modex allgather, two barriers, one xcast,
        with the port's workers under the port's HNP and under the JAX
        package's (the protocol is one)."""
        n = 4
        script = tmp_path / "worker.py"
        script.write_text(WORKER_SCRIPT)
        if hnp_pkg == "jax":
            from ompi_release_tpu.runtime.coordinator import (
                HnpCoordinator as Hnp)
        else:
            Hnp = HnpCoordinator
        hnp = Hnp(n)
        procs = [subprocess.Popen(
            [sys.executable, str(script), str(r), str(hnp.port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(1, n)]
        try:
            cards = hnp.run_modex({"host": "hnp", "devices": 0})
            assert [c["devices"] for c in cards] == [0, 1, 2, 3]
            hnp.barrier()
            hnp.xcast(b"job-config-v1")
            hnp.barrier()
        finally:
            hnp.shutdown()
        for p in procs:
            out, err = p.communicate(timeout=30)
            assert p.returncode == 0, err
            rec = json.loads(out.strip().splitlines()[-1])
            assert rec["n_cards"] == n and rec["xcast"] == "job-config-v1"


PUBSUB_SCRIPT = textwrap.dedent("""
    import sys, json, time
    sys.path.insert(0, %r)
    from ompi_release_tpu_torch.runtime.coordinator import WorkerAgent

    rank, port = int(sys.argv[1]), int(sys.argv[2])
    agent = WorkerAgent(rank, "127.0.0.1", port)
    agent.run_modex({"role": rank})
    if rank == 1:
        found = agent.lookup_name("ocean-svc", timeout_ms=15000)
        print(json.dumps({"rank": rank, "found": found}))
    else:
        time.sleep(0.5)
        agent.publish_name("ocean-svc", "tpu-port:42")
        found = agent.lookup_name("ocean-svc")
        try:
            agent.publish_name("ocean-svc", "tpu-port:43")
            dup_rejected = False
        except Exception:
            dup_rejected = True
        agent.unpublish_name("ocean-svc")
        print(json.dumps({"rank": rank, "found": found,
                          "dup_rejected": dup_rejected}))
    agent.close()
""" % REPO)


class TestNameServer:
    def test_publish_lookup_over_oob(self, tmp_path):
        n = 3
        script = tmp_path / "pubsub_worker.py"
        script.write_text(PUBSUB_SCRIPT)
        hnp = HnpCoordinator(n)
        hnp.start_name_server()
        procs = [subprocess.Popen(
            [sys.executable, str(script), str(r), str(hnp.port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(1, n)]
        try:
            hnp.run_modex({"role": "hnp"})
            recs = {}
            for p in procs:
                out, err = p.communicate(timeout=30)
                assert p.returncode == 0, err
                rec = json.loads(out.strip().splitlines()[-1])
                recs[rec["rank"]] = rec
        finally:
            hnp.shutdown()
        assert recs[1]["found"] == "tpu-port:42"
        assert recs[2]["found"] == "tpu-port:42"
        assert recs[2]["dup_rejected"] is True


def test_closed_endpoint_raises_not_segfaults():
    ep = OobEndpoint(0)
    port = ep.port
    ep.close()
    ep.close()
    with pytest.raises(MPIError):
        _ = ep.port
    with pytest.raises(MPIError):
        ep.send(1, 5, b"x")
    with pytest.raises(MPIError):
        ep.recv(tag=5, timeout_ms=50)
    with pytest.raises(MPIError):
        ep.connect(1, "127.0.0.1", port)


def _tree_digest(root):
    """sha256 of every file under ``root`` (relative names), skipping
    the JAX package's own ignored build directory."""
    out = {}
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "build"]
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_build_stays_out_of_the_reference_tree(tmp_path):
    """The port builds ``native/*.cc`` into a directory of its own: no
    file under ``native/`` changes, the stamp lands in the build
    directory, and a second build with a current stamp runs no make."""
    native_dir = os.path.join(REPO, "native")
    before = _tree_digest(native_dir)
    build = str(tmp_path / "native_build")
    so, ran = tnative.build_library(build)
    assert ran and os.path.exists(so) and so.startswith(build)
    assert os.path.exists(os.path.join(build, ".srcstamp"))
    so2, ran2 = tnative.build_library(build)
    assert so2 == so and not ran2  # the stamp is current: no make
    assert _tree_digest(native_dir) == before
    res = subprocess.run(["git", "status", "--porcelain", "native"],
                         cwd=REPO, capture_output=True, text=True)
    assert res.returncode != 0 or res.stdout.strip() == "", res.stdout


def test_build_lock_serializes_concurrent_builds(tmp_path):
    """Two processes building into one directory at once: one runs
    make, the other waits on the lock and finds the stamp current."""
    build = str(tmp_path / "shared_build")
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "from ompi_release_tpu_torch.native import build_library\n"
            "print(json.dumps(build_library(%r)[1]))\n" % (REPO, build))
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    ran = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        ran.append(json.loads(out.strip().splitlines()[-1]))
    assert sorted(ran) == [False, True]
