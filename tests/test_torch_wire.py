"""The port's pipelined wire transport (``runtime/wire.py`` and the DCN
staged path of ``btl/components.py``) held against
``tests/test_wire_pipeline.py``: fragmentation/reassembly parity,
channel concurrency, overlapped exchanges and the legacy framing
opt-out, plus the wire jobs (the one-sided window's wire cases wait for
the native datapath slice).

Parity discipline: fragmented transfers are BITWISE identical to
monolithic ones for every dtype and shape in the suite (tensors and
bf16 included), ``wire_pipeline_segsize=0`` restores the exact legacy
framing, pinned by sniffing the frames; and a transfer staged by the
port reassembles in the JAX package's receiver."""

import os
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from ompi_release_tpu.btl import components as jcomps
from ompi_release_tpu.mca import var as jvar
from ompi_release_tpu_torch.btl.components import (
    DcnBtl, _CHUNK2_MAGIC, _HDR2_MAGIC, _HDR_MAGIC)
from ompi_release_tpu_torch.mca import pvar as pvar_mod
from ompi_release_tpu_torch.mca import var as mca_var
from ompi_release_tpu_torch.native import DssBuffer, OobEndpoint
from ompi_release_tpu_torch.runtime.state import JobState
from ompi_release_tpu_torch.tools.tpurun import Job

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Segsize:
    def __init__(self, seg):
        self.seg = seg

    def __enter__(self):
        mca_var.set_value("wire_pipeline_segsize", self.seg)
        jvar.set_value("wire_pipeline_segsize", self.seg)

    def __exit__(self, *exc):
        mca_var.VARS.unset("wire_pipeline_segsize")
        jvar.VARS.unset("wire_pipeline_segsize")


@pytest.fixture
def pair():
    a, b = OobEndpoint(0), OobEndpoint(1)
    b.connect(0, "127.0.0.1", a.port)
    yield a, b
    a.close()
    b.close()


class TestStagedPipelineParity:
    @pytest.mark.parametrize("seg", [0, 1024, 4096])
    def test_fragmented_equals_monolithic_bitwise(self, pair, seg):
        a, b = pair
        m = DcnBtl()
        rng = np.random.RandomState(seg)
        with _Segsize(seg):
            for n in (0, 1, 37, 255, 256, 257, 1023, 1024, 1025, 50_000):
                for dt in (np.float32, np.int32, np.uint8):
                    x = (rng.randn(n) * 100).astype(dt)
                    m.send_staged(b, 0, 151, x)
                    got = m.recv_staged(a, 151).numpy()
                    assert got.dtype == x.dtype and got.shape == x.shape
                    np.testing.assert_array_equal(got, x)
                t = torch.from_numpy((rng.randn(n) * 9).astype(np.float32))
                for tt in (t, t.to(torch.bfloat16), t.to(torch.int64)):
                    m.send_staged(b, 0, 151, tt)
                    got = m.recv_staged(a, 151)
                    assert got.dtype == tt.dtype and got.shape == tt.shape
                    assert torch.equal(got, tt)
            x = rng.randn(13, 7).astype(np.float32)
            m.send_staged(b, 0, 151, x)
            np.testing.assert_array_equal(m.recv_staged(a, 151).numpy(), x)
        with _Segsize(1024):
            for nb in (1023, 1024, 1025, 2048, 2049):
                x = rng.randint(0, 255, nb).astype(np.uint8)
                m.send_staged(b, 0, 151, x)
                np.testing.assert_array_equal(
                    m.recv_staged(a, 151).numpy(), x)

    def test_segsize_zero_restores_legacy_framing(self, pair):
        a, b = pair
        m = DcnBtl()
        with _Segsize(0):
            m.send_staged(b, 0, 153, np.arange(64, dtype=np.float32))
        _, _, hraw = a.recv(tag=153, timeout_ms=10_000)
        assert DssBuffer(hraw).unpack_string() == _HDR_MAGIC
        a.recv(tag=153, timeout_ms=10_000)
        with _Segsize(64):
            m.send_staged(b, 0, 153, np.arange(64, dtype=np.float32))
        _, _, hraw = a.recv(tag=153, timeout_ms=10_000)
        assert DssBuffer(hraw).unpack_string() == _HDR2_MAGIC
        for _ in range(4):
            _, _, raw = a.recv(tag=153, timeout_ms=10_000)
            assert raw.startswith(_CHUNK2_MAGIC)

    def test_interleaved_tags_one_peer(self, pair):
        a, b = pair
        m = DcnBtl()
        rng = np.random.RandomState(1)
        x1 = rng.randn(2000).astype(np.float32)
        x2 = (rng.randn(1500) * 9).astype(np.int32)
        alive = [(iter(m.staged_frames(x1, segsize=512)), 201),
                 (iter(m.staged_frames(x2, segsize=512)), 202)]
        while alive:
            keep = []
            for it, tag in alive:
                try:
                    b.send(0, tag, next(it))
                    keep.append((it, tag))
                except StopIteration:
                    pass
            alive = keep
        np.testing.assert_array_equal(m.recv_staged(a, 202).numpy(), x2)
        np.testing.assert_array_equal(m.recv_staged(a, 201).numpy(), x1)

    def test_interleaved_senders_one_tag_pipelined(self):
        root, s1, s2 = OobEndpoint(0), OobEndpoint(1), OobEndpoint(2)
        try:
            s1.connect(0, "127.0.0.1", root.port)
            s2.connect(0, "127.0.0.1", root.port)
            m = DcnBtl()
            with _Segsize(4096):
                x1 = np.full(30_000, 1.5, np.float32)
                x2 = np.full(40_000, 2.5, np.float32)
                t1 = threading.Thread(
                    target=lambda: m.send_staged(s1, 0, 109, x1))
                t2 = threading.Thread(
                    target=lambda: m.send_staged(s2, 0, 109, x2))
                t1.start()
                t2.start()
                got = [m.recv_staged(root, 109).numpy() for _ in range(2)]
                t1.join()
                t2.join()
                got = {arr.shape[0]: arr for arr in got}
                np.testing.assert_array_equal(got[30_000], x1)
                np.testing.assert_array_equal(got[40_000], x2)
        finally:
            for e in (root, s1, s2):
                e.close()

    def test_zero_copy_and_inflight_pvars_account(self, pair):
        a, b = pair
        m = DcnBtl()
        zc = pvar_mod.PVARS.lookup("wire_bytes_zero_copy")
        fi = pvar_mod.PVARS.lookup("wire_frags_inflight")
        assert zc is not None and fi is not None
        before = float(zc.read())
        with _Segsize(1024):
            x = np.ones(4096, np.uint8)
            m.send_staged(b, 0, 155, x)
            np.testing.assert_array_equal(m.recv_staged(a, 155).numpy(), x)
        assert float(zc.read()) - before >= 2 * 4096
        assert float(fi.read()) >= 4

    @pytest.mark.parametrize("seg", [0, 4096])
    def test_port_stages_jax_reassembles(self, seg):
        """One framing: the port's staged transfer of a tensor lands in
        the JAX package's receiver bitwise."""
        from ompi_release_tpu.native import OobEndpoint as JOob

        srv, cli = JOob(0), OobEndpoint(1)
        try:
            cli.connect(0, "127.0.0.1", srv.port)
            x = torch.arange(30_001, dtype=torch.float32) * 0.5
            with _Segsize(seg):
                DcnBtl().send_staged(cli, 0, 160, x)
                got = np.asarray(jcomps.DcnBtl().recv_staged(srv, 160))
            np.testing.assert_array_equal(got, x.numpy())
        finally:
            cli.close()
            srv.close()


APP_PRELUDE = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, %r)
    import numpy as np
    import torch
    import ompi_release_tpu_torch as mpi
    from ompi_release_tpu_torch.mca import pvar, var as mca_var
    from ompi_release_tpu_torch.runtime.runtime import Runtime

    def init(nvirt=4):
        return mpi.init(cli_args=["--mca", "runtime_virtual_ranks",
                                  str(nvirt)], device="cpu")
""" % REPO)


def _run(tmp_path, capfd, body, n=2, timeout=180, mca=()):
    app = tmp_path / "app.py"
    app.write_text(APP_PRELUDE + textwrap.dedent(body))
    job = Job(n, [sys.executable, str(app)], list(mca), heartbeat_s=0.5,
              miss_limit=8)
    rc = job.run(timeout_s=timeout)
    out = capfd.readouterr()
    assert rc == 0, out.out + out.err
    assert job.job_state.visited(JobState.TERMINATED)
    return out.out


class TestWireJobs:
    def test_pipelined_dcn_parity_and_concurrent_tags(self, tmp_path,
                                                      capfd):
        out = _run(tmp_path, capfd, """
            import threading
            os.environ["OMPITPU_HOST_ID"] = (
                "fakehost-" + os.environ["OMPITPU_NODE_ID"])
            world = init()
            off = Runtime.current().local_rank_offset
            n = world.size
            assert int(mca_var.get("wire_pipeline_segsize")) == 65536
            x = np.stack([np.arange(65536, dtype=np.int32) * (off + i + 1)
                          for i in range(4)])
            got = world.allreduce(x).numpy()
            want = sum(np.arange(65536, dtype=np.int32) * (r + 1)
                       for r in range(n))
            np.testing.assert_array_equal(got[0], want)
            full = [np.arange(10_000 + r, dtype=np.int32) + r
                    for r in range(n)]
            ag = world.allgatherv(full[off:off + 4]).numpy()
            np.testing.assert_array_equal(ag, np.concatenate(full))
            big1 = np.arange(1 << 19, dtype=np.float32)
            big2 = np.arange(1 << 19, dtype=np.float32) * -2.0
            if off == 0:
                ts = [threading.Thread(target=lambda: world.send(
                          big1, 5, tag=1, rank=1)),
                      threading.Thread(target=lambda: world.send(
                          big2, 6, tag=2, rank=2))]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join()
            else:
                v2, st2 = world.recv(source=2, tag=2, rank=6)
                v1, st1 = world.recv(source=1, tag=1, rank=5)
                np.testing.assert_array_equal(v1.numpy(), big1)
                np.testing.assert_array_equal(v2.numpy(), big2)
            world.barrier()
            assert pvar.PVARS.read_all()["wire_bytes_zero_copy"] > 0
            print(f"WIREPIPE-OK {off}")
            mpi.finalize()
        """, mca=[("wire_pipeline_segsize", "65536")])
        assert "WIREPIPE-OK 0" in out and "WIREPIPE-OK 4" in out

    def test_exchange_reaps_in_arrival_order(self, tmp_path, capfd):
        out = _run(tmp_path, capfd, """
            import time
            world = init(2)      # 3 procs x 2 ranks
            rt = Runtime.current()
            me = rt.bootstrap["process_index"]
            router = rt.wire
            payload = np.full(1000, me, np.int32)
            if me == 0:
                pending = {1: 1, 2: 1}
                srcs, got = [], {}
                while sum(pending.values()):
                    src, arr = router.coll_recv_any(world, pending)
                    pending[src] -= 1
                    srcs.append(src)
                    got[src] = np.asarray(arr)
                assert srcs[0] == 2, f"reaped {srcs} (slow peer first)"
                for s in (1, 2):
                    np.testing.assert_array_equal(
                        got[s], np.full(1000, s, np.int32))
                print("ARRIVAL-ORDER-OK")
            elif me == 1:
                time.sleep(0.8)
                router.coll_send(world, 0, payload)
            else:
                router.coll_send(world, 0, payload)
            world.barrier()
            mpi.finalize()
        """, n=3)
        assert "ARRIVAL-ORDER-OK" in out

    def test_legacy_single_frame_path_opt_out(self, tmp_path, capfd):
        out = _run(tmp_path, capfd, """
            world = init()
            off = Runtime.current().local_rank_offset
            n = world.size
            x = np.stack([np.arange(4096, dtype=np.int32) * (off + i + 1)
                          for i in range(4)])
            got = world.allreduce(x).numpy()
            want = sum(np.arange(4096, dtype=np.int32) * (r + 1)
                       for r in range(n))
            np.testing.assert_array_equal(got[0], want)
            if off == 0:
                world.send(np.arange(1 << 18, dtype=np.float32), 5,
                           tag=7, rank=1)
            else:
                v, st = world.recv(source=1, tag=7, rank=5)
                np.testing.assert_array_equal(
                    v.numpy(), np.arange(1 << 18, dtype=np.float32))
            world.barrier()
            print(f"LEGACY-OK {off}")
            mpi.finalize()
        """, mca=[("wire_pipeline_segsize", "0"), ("wire_p2p_lanes", "1"),
                  ("wire_overlap_exchange", "false")])
        assert "LEGACY-OK 0" in out and "LEGACY-OK 4" in out

    def test_bf16_and_int64_payloads_cross_processes(self, tmp_path, capfd):
        """bf16 crosses as raw words with its dtype in the header: a
        send arrives as a bf16 tensor, and the hier collectives move
        bf16 bitwise (allgather) and fold it (allreduce) exactly."""
        out = _run(tmp_path, capfd, """
            world = init()
            off = Runtime.current().local_rank_offset
            n = world.size
            x = torch.stack([(torch.arange(40) * 0.5 + r).to(torch.bfloat16)
                             for r in range(off, off + 4)])
            ag = world.allgather(x)
            want = torch.cat([(torch.arange(40) * 0.5 + r).to(
                torch.bfloat16) for r in range(n)])
            assert ag.dtype == torch.bfloat16 and torch.equal(ag[0], want)
            ar = world.allreduce(x)
            assert ar.dtype == torch.bfloat16
            assert torch.equal(ar[0].float(), (torch.arange(40) * 4.0 + 28))
            if off == 0:
                world.send(want, 6, tag=3, rank=0)
                world.send(torch.arange(7, dtype=torch.int64) - 2**40, 7,
                           tag=4, rank=1)
            else:
                v, _ = world.recv(source=0, tag=3, rank=6)
                assert v.dtype == torch.bfloat16 and torch.equal(v, want)
                v, _ = world.recv(source=1, tag=4, rank=7)
                assert v.dtype == torch.int64
                assert torch.equal(v, torch.arange(7) - 2**40)
            world.barrier()
            print(f"DTYPES-OK {off}")
            mpi.finalize()
        """)
        assert "DTYPES-OK 0" in out and "DTYPES-OK 4" in out
