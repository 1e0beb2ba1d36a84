"""The port's btl/bml layer (``ompi_release_tpu_torch/btl``) held against
``tests/test_btl.py``: reachability, exclusivity tiers and ranked lists,
weighted rail striping, framework selection, the honest DCN staging
path and the shm handoff — plus the port's host staging (tensors and
bf16 cross as raw words with their dtype in the header; the frames are
byte-identical to the JAX package's) and a garbage collection forced
inside ``ShmBtl`` registration, which must not hang."""

import gc
import subprocess
import sys
import textwrap
import threading
import weakref
import zlib

import numpy as np
import pytest
import torch

from ompi_release_tpu.btl import components as jcomps
from ompi_release_tpu.native import OobEndpoint as JOob
from ompi_release_tpu_torch import btl as btl_mod
from ompi_release_tpu_torch.btl import base as btl_base
from ompi_release_tpu_torch.btl import components as btl_comps
from ompi_release_tpu_torch.mca import var as mca_var
from ompi_release_tpu_torch.native import DssBuffer, OobEndpoint
from ompi_release_tpu_torch.runtime import runtime as trt
from ompi_release_tpu_torch.runtime.mesh import Endpoint
from ompi_release_tpu_torch.utils.errors import MPIError

REPO = __file__.rsplit("/tests/", 1)[0]


@pytest.fixture(scope="module")
def world():
    import ompi_release_tpu_torch as tmpi

    trt._reset_for_tests()
    w = tmpi.init(cli_args=["--mca", "runtime_virtual_ranks", "8"],
                  device="cpu")
    yield w
    trt._reset_for_tests()


def _ep(rank, slice_index=0, process_index=0, platform="cpu", host=""):
    return Endpoint(rank=rank, device_id=rank, process_index=process_index,
                    platform=platform, device_kind="test", coords=(rank,),
                    slice_index=slice_index, host=host)


@pytest.fixture
def pair():
    a, b = OobEndpoint(0), OobEndpoint(1)
    b.connect(0, "127.0.0.1", a.port)
    yield a, b
    a.close()
    b.close()


class TestReachability:
    def test_self_owns_loopback(self):
        m = btl_comps.SelfBtl()
        assert m.reachable(_ep(3), _ep(3))
        assert not m.reachable(_ep(3), _ep(4))

    def test_ici_same_slice_only(self):
        m = btl_comps.IciBtl()
        assert m.reachable(_ep(0), _ep(1))
        assert not m.reachable(_ep(0), _ep(1, slice_index=1))
        assert not m.reachable(_ep(0), _ep(0))
        assert not m.reachable(_ep(0), _ep(1, process_index=1))

    def test_dcn_cross_slice_or_process(self):
        m = btl_comps.DcnBtl()
        assert m.reachable(_ep(0), _ep(1, slice_index=1))
        assert m.reachable(_ep(0), _ep(1, process_index=1))
        assert not m.reachable(_ep(0), _ep(1))

    def test_host_reaches_everything(self):
        assert btl_comps.HostBtl().reachable(
            _ep(0), _ep(1, slice_index=9, process_index=9))


class TestEndpointLists:
    def _modules(self):
        return [btl_comps.SelfBtl(), btl_comps.IciBtl(),
                btl_comps.DcnBtl(), btl_comps.HostBtl()]

    def test_exclusivity_tiers(self):
        ep = btl_base.BmlEndpoint(_ep(0), _ep(0), None, self._modules())
        assert [m.NAME for m in ep.btl_eager] == ["self"]
        ep = btl_base.BmlEndpoint(_ep(0), _ep(1), None, self._modules())
        assert [m.NAME for m in ep.btl_eager] == ["ici"]
        ep = btl_base.BmlEndpoint(_ep(0), _ep(1, slice_index=1), None,
                                  self._modules())
        assert [m.NAME for m in ep.btl_eager] == ["dcn"]

    def test_unreachable_raises(self):
        with pytest.raises(MPIError):
            btl_base.BmlEndpoint(_ep(0), _ep(1), None,
                                 [btl_comps.SelfBtl()])

    def test_rdma_sorted_by_bandwidth_eager_by_latency(self):
        class A(btl_comps.IciBtl):
            NAME = "railA"
            LATENCY = 5
            BANDWIDTH = 100
            EXCLUSIVITY = 7

        class B(btl_comps.IciBtl):
            NAME = "railB"
            LATENCY = 1
            BANDWIDTH = 50
            EXCLUSIVITY = 7

        ep = btl_base.BmlEndpoint(_ep(0), _ep(1), None, [A(), B()])
        assert [m.NAME for m in ep.btl_eager] == ["railB", "railA"]
        assert [m.NAME for m in ep.btl_rdma] == ["railA", "railB"]


class TestStriping:
    def test_rail_schedule_weighted_by_bandwidth(self):
        class A(btl_comps.IciBtl):
            NAME = "rail3x"
            BANDWIDTH = 300
            EXCLUSIVITY = 7

        class B(btl_comps.IciBtl):
            NAME = "rail1x"
            BANDWIDTH = 100
            EXCLUSIVITY = 7

        ep = btl_base.BmlEndpoint(_ep(0), _ep(1), None, [A(), B()])
        sched = ep._rail_schedule(8)
        assert sched.count(0) == 6 and sched.count(1) == 2
        assert set(sched[:2]) == {0, 1}

    def test_striped_move_correct_and_counted(self, world):
        class A(btl_comps.IciBtl):
            NAME = "ici"
            EXCLUSIVITY = 7

        class B(btl_comps.IciBtl):
            NAME = "host"
            BANDWIDTH = 15_000
            EXCLUSIVITY = 7

        pinned = {"btl_host_bandwidth": "15000",
                  "btl_host_exclusivity": "1024", "btl_host_latency": "1",
                  "btl_ici_exclusivity": "1024"}
        BmlR2 = btl_mod.BmlR2  # registers the btl vars
        BmlR2(world)
        for k, v in pinned.items():
            mca_var.set_value(k, v)
        try:
            dst = world.submesh.devices.reshape(-1)[1]
            ep = btl_base.BmlEndpoint(_ep(0), _ep(1), dst, [A(), B()])
            x = torch.arange(5000, dtype=torch.float32)
            before = btl_base._striped_moves.read()
            out = ep.move(x, max_send=4096)  # 1024 f32 a segment: 5
            assert torch.equal(out, x) and out.device == dst
            assert btl_base._striped_moves.read() == before + 1
        finally:
            for k in pinned:
                mca_var.VARS.unset(k)


class TestSelection:
    def test_framework_selection_var(self, world):
        mca_var.set_value("btl", "host,self")
        try:
            ep = btl_mod.BmlR2(world).endpoint(0, 1)
            assert [m.NAME for m in ep.btl_eager] == ["host"]
            x = torch.arange(64, dtype=torch.int32)
            assert torch.equal(ep.move(x), x)
        finally:
            mca_var.VARS.unset("btl")

    def test_default_world_endpoints(self, world):
        bml = btl_mod.BmlR2(world)
        assert [m.NAME for m in bml.endpoint(0, 0).btl_eager] == ["self"]
        assert [m.NAME for m in bml.endpoint(0, 1).btl_eager] == ["ici"]

    def test_attribute_vars_override(self, world):
        btl_mod.BmlR2(world)
        mca_var.set_value("btl_ici_eager_limit", 128)
        try:
            assert btl_mod.BmlR2(world).endpoint(0, 1).eager_limit == 128
        finally:
            mca_var.VARS.unset("btl_ici_eager_limit")


class TestHonestDcn:
    def test_move_segment_unaddressable_raises(self):
        class FakeDevice:  # a peer process's device
            process_index = 1

        with pytest.raises(MPIError) as ei:
            btl_comps.DcnBtl().move_segment(torch.ones(4), FakeDevice())
        assert "send_staged" in str(ei.value)

    def test_staged_transfer_in_process_sockets(self, pair):
        a, b = pair
        m = btl_comps.DcnBtl()
        mca_var.set_value("btl_dcn_max_send_size", str(1 << 20))
        mca_var.set_value("wire_pipeline_segsize", 0)
        try:
            x = np.random.RandomState(0).randn(3 << 18).astype(np.float32)
            before = int(m.staged_chunks_pvar.read())
            assert m.send_staged(b, 0, 121, x) == 3
            got = m.recv_staged(a, 121)
            assert isinstance(got, torch.Tensor)
            np.testing.assert_array_equal(got.numpy(), x)
            assert int(m.staged_chunks_pvar.read()) - before == 6
        finally:
            mca_var.VARS.unset("btl_dcn_max_send_size")
            mca_var.VARS.unset("wire_pipeline_segsize")

    def test_staged_transfer_cross_process(self, tmp_path):
        script = textwrap.dedent("""
            import sys
            sys.path.insert(0, %r)
            import torch
            from ompi_release_tpu_torch.btl.components import DcnBtl
            from ompi_release_tpu_torch.native import OobEndpoint

            ep = OobEndpoint(1)
            ep.connect(0, "127.0.0.1", int(sys.argv[1]))
            DcnBtl().send_staged(ep, 0, 133,
                                 torch.arange(200_000, dtype=torch.float32))
            ep.recv(tag=134, timeout_ms=30000)
            ep.close()
        """ % REPO)
        p = tmp_path / "dcn_sender.py"
        p.write_text(script)
        ep = OobEndpoint(0)
        try:
            proc = subprocess.Popen([sys.executable, str(p), str(ep.port)],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE)
            got = btl_comps.DcnBtl().recv_staged(ep, 133)
            assert torch.equal(got, torch.arange(200_000,
                                                 dtype=torch.float32))
            ep.send(1, 134, b"ok")
            _, err = proc.communicate(timeout=30)
            assert proc.returncode == 0, err
        finally:
            ep.close()

    def test_concurrent_staged_transfers_do_not_interleave(self):
        root = OobEndpoint(0)
        s1, s2 = OobEndpoint(1), OobEndpoint(2)
        try:
            s1.connect(0, "127.0.0.1", root.port)
            s2.connect(0, "127.0.0.1", root.port)
            m = btl_comps.DcnBtl()
            mca_var.set_value("btl_dcn_max_send_size", str(64 * 1024))
            try:
                x1 = np.full(100_000, 1.0, np.float32)
                x2 = np.full(120_000, 2.0, np.float32)
                t1 = threading.Thread(
                    target=lambda: m.send_staged(s1, 0, 109, x1))
                t2 = threading.Thread(
                    target=lambda: m.send_staged(s2, 0, 109, x2))
                t1.start()
                t2.start()
                a = m.recv_staged(root, 109).numpy()
                b = m.recv_staged(root, 109).numpy()
                t1.join()
                t2.join()
                got = {arr.shape[0]: arr for arr in (a, b)}
                np.testing.assert_array_equal(got[100_000], x1)
                np.testing.assert_array_equal(got[120_000], x2)
            finally:
                mca_var.VARS.unset("btl_dcn_max_send_size")
        finally:
            for e in (root, s1, s2):
                e.close()

    def test_recv_staged_resyncs_past_orphan_frames(self, pair):
        a, b = pair
        stale = (btl_comps._CHUNK_MAGIC + (424242).to_bytes(8, "big")
                 + b"junk")
        b.send(0, 151, stale)
        b.send(0, 151, stale)
        x = np.arange(1000, dtype=np.float32)
        btl_comps.DcnBtl().send_staged(b, 0, 151, x)
        np.testing.assert_array_equal(
            btl_comps.DcnBtl().recv_staged(a, 151).numpy(), x)

    def test_control_plane_tags_rejected(self):
        with pytest.raises(MPIError):
            btl_comps.DcnBtl().send_staged(None, 0, 9, np.ones(2))
        with pytest.raises(MPIError):
            btl_comps.ShmBtl().send_shm(None, 0, 5, np.ones(2))

    def test_staged_transfer_crc_catches_corruption(self, pair):
        a, b = pair
        good = np.arange(64, dtype=np.float32).tobytes()
        hdr = DssBuffer()
        hdr.pack_string(btl_comps._HDR_MAGIC)
        hdr.pack_int64(7)
        hdr.pack_string("float32")
        hdr.pack_string("64")
        hdr.pack_int64(1)
        hdr.pack_int64(zlib.crc32(good))
        b.send(0, 161, hdr.tobytes())
        corrupted = bytearray(good)
        corrupted[12] ^= 0xFF
        b.send(0, 161, btl_comps._CHUNK_MAGIC + (7).to_bytes(8, "big")
               + bytes(corrupted))
        with pytest.raises(MPIError) as ei:
            btl_comps.DcnBtl().recv_staged(a, 161)
        assert "CRC" in str(ei.value)


class TestStaging:
    @pytest.mark.parametrize("segsize", [0, 1 << 16])
    def test_frames_identical_to_the_jax_package(self, segsize):
        """The port's staged frames for a host payload are the JAX
        package's, byte for byte (transfer ids aside), under both
        framings; a JAX receiver reassembles the port's transfer."""
        x = np.arange(50_000, dtype=np.float32) * 0.25
        tf = list(btl_comps.DcnBtl().staged_frames(x, segsize=1 << 16))
        jf = list(jcomps.DcnBtl().staged_frames(x, segsize=1 << 16))
        assert len(tf) == len(jf)
        strip = lambda f: f[:4] + f[12:]  # noqa: E731  (the xfer id)
        for a, b in zip(tf[1:], jf[1:]):
            assert strip(a) == strip(b)
        from ompi_release_tpu.mca import var as jvar

        mca_var.set_value("wire_pipeline_segsize", segsize)
        jvar.set_value("wire_pipeline_segsize", segsize)
        srv, cli = JOob(0), OobEndpoint(1)
        try:
            cli.connect(0, "127.0.0.1", srv.port)
            btl_comps.DcnBtl().send_staged(cli, 0, 170, x)
            got = jcomps.DcnBtl().recv_staged(srv, 170)
            np.testing.assert_array_equal(np.asarray(got), x)
        finally:
            mca_var.VARS.unset("wire_pipeline_segsize")
            jvar.VARS.unset("wire_pipeline_segsize")
            cli.close()
            srv.close()

    @pytest.mark.parametrize("via", ["staged", "shm"])
    def test_bf16_crosses_as_raw_words(self, pair, via):
        a, b = pair
        x = (torch.randn(4099, generator=torch.Generator().manual_seed(3))
             .to(torch.bfloat16))
        if via == "staged":
            btl_comps.DcnBtl().send_staged(b, 0, 171, x)
            got = btl_comps.DcnBtl().recv_staged(a, 171)
        else:
            btl_comps.ShmBtl().send_shm(b, 0, 172, x)
            got = btl_comps.ShmBtl().recv_shm(a, 172)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), x.view(torch.int16))

    def test_host_payload_and_tensor_roundtrip(self):
        for t in (torch.arange(10, dtype=torch.int64),
                  torch.ones(3, 4, dtype=torch.float16),
                  torch.tensor([1.5, -2.0]).to(torch.bfloat16)):
            arr, name = btl_comps.host_payload(t)
            back = btl_comps.host_tensor(arr.copy(), name)
            assert back.dtype == t.dtype and torch.equal(back, t)
        arr, name = btl_comps.host_payload(np.zeros((2, 2), np.int32))
        assert name == "int32" and arr.shape == (2, 2)


class TestShmHandoff:
    def test_reachability_same_host_cross_process_only(self):
        m = btl_comps.ShmBtl()
        a = _ep(rank=0, process_index=0, host="hostA")
        b = _ep(rank=1, process_index=1, host="hostA")
        c = _ep(rank=2, process_index=1, host="hostB")
        d = _ep(rank=3, process_index=0, host="hostA")
        assert m.reachable(a, b)
        assert not m.reachable(a, c)
        assert not m.reachable(a, d)
        assert not m.reachable(_ep(rank=4, process_index=1, host=""), b)

    def test_handoff_cross_process(self, tmp_path):
        script = textwrap.dedent("""
            import sys
            sys.path.insert(0, %r)
            import numpy as np
            from ompi_release_tpu_torch.btl.components import ShmBtl
            from ompi_release_tpu_torch.native import OobEndpoint

            ep = OobEndpoint(1)
            ep.connect(0, "127.0.0.1", int(sys.argv[1]))
            ShmBtl().send_shm(ep, 0, 144,
                              np.arange(200_000, dtype=np.float32) * 0.5)
            ep.recv(tag=145, timeout_ms=30000)
            ep.close()
        """ % REPO)
        p = tmp_path / "shm_sender.py"
        p.write_text(script)
        ep = OobEndpoint(0)
        try:
            proc = subprocess.Popen([sys.executable, str(p), str(ep.port)],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE)
            got = btl_comps.ShmBtl().recv_shm(ep, 144)
            np.testing.assert_array_equal(
                got.numpy(), np.arange(200_000, dtype=np.float32) * 0.5)
            ep.send(1, 145, b"ok")
            _, err = proc.communicate(timeout=30)
            assert proc.returncode == 0, err
        finally:
            ep.close()

    def test_move_segment_refuses(self):
        with pytest.raises(MPIError):
            btl_comps.ShmBtl().move_segment(torch.ones(3), None)

    def test_orphaned_segments_reaped(self, pair):
        from multiprocessing import shared_memory

        a, b = pair
        m = btl_comps.ShmBtl()
        name = m.send_shm(b, 0, 177, np.ones(16, np.float32))
        shared_memory.SharedMemory(name=name).close()
        m._pending_segments[:] = [(n, 0.0) for n, _ in m._pending_segments]
        m.send_shm(b, 0, 178, np.ones(4, np.float32))
        with pytest.raises(FileNotFoundError):
            shared_memory.SharedMemory(name=name)
        m.recv_shm(a, 178)

    def test_gc_inside_registration_does_not_hang(self):
        """A garbage collection that runs a collected ShmBtl's finalizer
        while another instance is registering (the reaper lock held on
        this thread) must re-enter the lock, not deadlock on it."""
        done = threading.Event()
        errors = []

        class CollectingSet(weakref.WeakSet):
            def add(self, item):
                gc.collect()  # runs the cycle's finalizer right here
                super().add(item)

        def run():
            try:
                saved = btl_comps.ShmBtl._instances
                btl_comps.ShmBtl._instances = CollectingSet()
                try:
                    for _ in range(3):
                        cyc = btl_comps.ShmBtl()
                        cyc.me = cyc  # collectable only by the cycle GC
                        cyc._pending_segments.append(("ompitpu-none", 1e18))
                        del cyc
                        btl_comps.ShmBtl()  # registration collects it
                finally:
                    btl_comps.ShmBtl._instances = saved
            except Exception as e:  # surfaced below
                errors.append(e)
            finally:
                done.set()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        assert done.wait(20), "ShmBtl registration hung in a GC finalizer"
        assert not errors, errors
        with btl_comps.ShmBtl._reaper_lock:
            orphaned = [n for n, _ in btl_comps.ShmBtl._orphaned]
            btl_comps.ShmBtl._orphaned[:] = [
                r for r in btl_comps.ShmBtl._orphaned
                if r[0] != "ompitpu-none"]
        assert orphaned.count("ompitpu-none") == 3
