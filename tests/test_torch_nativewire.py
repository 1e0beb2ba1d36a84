"""The port's ``btl/nativewire`` held against ``tests/test_nativewire.py``
and against the JAX package's frames.

- **byte identity**: the port's native frame stream joins byte-identical
  to the port's staged frames AND to the JAX package's
  ``DcnBtl.staged_frames`` for the same seeded arrays, across a segsize
  x lane x dtype matrix (same xfer ids); the frozen-template leg
  matches ``planned_frames``; a template mismatch is loud.
- **real sockets**: native sender -> portable receiver and back, within
  the port and across the two packages (the JAX package's endpoint and
  staged path on one side, the port's native path on the other); a
  corrupted fragment fails the CRC with ``ERR_TRUNCATE``; the co-hosted
  shm-ring mode in one process; a ring holding undelivered bytes
  survives its producer's release until a consumer maps it.
- **selection**: the component registers at import and withdraws under
  the env kill switch, the cvar, or a card that never advertised;
  modex cards round-trip; a garbage collection that releases a module's
  rings while another ring registers (the telemetry lock held) does not
  hang.
- **jobs**: 3-process port jobs (2 virtual ranks each) run the
  collective families and p2p bitwise over the shm rings and over the
  vectored sockets; a mixed fleet (one worker with the kill switch)
  falls back per peer; no ring is left in /dev/shm.
"""

import gc
import glob
import itertools
import os
import subprocess
import sys
import textwrap
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from ompi_release_tpu.btl import components as jbtl
from ompi_release_tpu_torch.btl import components as btl_comps
from ompi_release_tpu_torch.btl import nativewire as nw
from ompi_release_tpu_torch.mca import var as mca_var
from ompi_release_tpu_torch.runtime.state import JobState
from ompi_release_tpu_torch.tools.tpurun import Job
from ompi_release_tpu_torch.utils.errors import ErrorCode, MPIError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the wire p2p tag base + lane stride (lanes differ above bit 17)
USER_TAG = 1 << 20
LANE_STRIDE = 1 << 17


def _cards(hosts, capable=None, pids=None):
    """Modex cards for a fake fleet: ``hosts[i]`` is pidx i's host,
    ``capable`` the set of pidxs advertising the native datapath."""
    capable = set(range(len(hosts))) if capable is None else capable
    out = []
    for i, h in enumerate(hosts):
        card = {"host": h, "pid": (pids or {}).get(i, os.getpid()),
                "node_id": i + 1}
        if i in capable:
            card[nw.CARD_KEY] = f"tok{os.getpid()}x{i}:4:{8 << 20}"
        out.append(card)
    return out


class _CaptureEp:
    """OOB stand-in recording every frame as its joined wire bytes —
    sendv MUST be byte-equivalent to send(b"".join(parts))."""

    def __init__(self):
        self.frames = []

    def send(self, nid, tag, data):
        self.frames.append(bytes(data))

    def sendv(self, nid, tag, parts):
        self.frames.append(b"".join(bytes(p) for p in parts))


@pytest.fixture
def seg(request):
    mca_var.set_value("wire_pipeline_segsize", str(request.param))
    try:
        yield int(request.param)
    finally:
        mca_var.VARS.unset("wire_pipeline_segsize")


def _with_xfer(start, fn):
    """Run ``fn`` with both packages' transfer-id counters at ``start``."""
    saved = btl_comps._xfer_ids, jbtl._xfer_ids
    try:
        btl_comps._xfer_ids = itertools.count(start)
        jbtl._xfer_ids = itertools.count(start)
        return fn()
    finally:
        btl_comps._xfer_ids, jbtl._xfer_ids = saved


class TestByteIdentity:
    @pytest.mark.parametrize("seg", [256, 1000, 64 * 1024], indirect=True)
    @pytest.mark.parametrize("lane", [0, 3])
    @pytest.mark.parametrize(
        "dtype,n", [(np.float32, 7321), (np.int16, 4096), (np.uint8, 1)])
    def test_native_frames_equal_staged_and_jax_frames(self, seg, lane,
                                                       dtype, n):
        """b''.join of every native scatter-gather list == the port's
        staged frame == the JAX package's staged frame, header and the
        ragged tail included."""
        mod = nw.NativeWireBtl()
        mod.bind(_cards(["hostA", "hostB"]), 0)  # distinct: sendv path
        x = (np.random.default_rng(n).integers(0, 251, n)).astype(dtype)
        tag = USER_TAG + lane * LANE_STRIDE + 5

        def native():
            ep = _CaptureEp()
            for _ in mod.frame_stream(ep, 1, tag, x):
                pass
            return ep.frames

        got = _with_xfer(9000, native)
        ref = _with_xfer(9000, lambda: list(
            btl_comps.DcnBtl().staged_frames(x, segsize=seg)))
        jref = _with_xfer(9000, lambda: list(
            jbtl.DcnBtl().staged_frames(x, segsize=seg)))
        assert got == ref == jref

    @pytest.mark.parametrize("seg", [256], indirect=True)
    def test_planned_template_same_identity(self, seg):
        """The frozen-template leg matches planned_frames, the port's
        and the JAX package's."""
        mod = nw.NativeWireBtl()
        mod.bind(_cards(["hostA", "hostB"]), 0)
        x = np.random.default_rng(3).standard_normal(600)
        tpl = btl_comps.plan_frame_template(x.shape, str(x.dtype), seg)
        jtpl = jbtl.plan_frame_template(x.shape, x.dtype, seg)

        def native():
            ep = _CaptureEp()
            for _ in mod.frame_stream(ep, 1, USER_TAG + 9, x, tpl=tpl):
                pass
            return ep.frames

        got = _with_xfer(77, native)
        ref = _with_xfer(77, lambda: list(
            btl_comps.DcnBtl().planned_frames(x, tpl)))
        jref = _with_xfer(77, lambda: list(
            jbtl.DcnBtl().planned_frames(x, jtpl)))
        assert got == ref == jref

    def test_tensor_payload_frames_like_its_array(self):
        """A host tensor (bf16 included) frames exactly as its storage
        array under the port's wire dtype name."""
        mca_var.set_value("wire_pipeline_segsize", "512")
        try:
            mod = nw.NativeWireBtl()
            mod.bind(_cards(["hostA", "hostB"]), 0)
            t = torch.arange(700, dtype=torch.float32).to(torch.bfloat16)

            def native():
                ep = _CaptureEp()
                for _ in mod.frame_stream(ep, 1, USER_TAG + 2, t):
                    pass
                return ep.frames

            got = _with_xfer(5, native)
            ref = _with_xfer(5, lambda: list(
                btl_comps.DcnBtl().staged_frames(t, segsize=512)))
        finally:
            mca_var.VARS.unset("wire_pipeline_segsize")
        assert got == ref
        assert b"bfloat16" in got[0]

    @pytest.mark.parametrize("seg", [256], indirect=True)
    def test_template_mismatch_is_loud(self, seg):
        mod = nw.NativeWireBtl()
        mod.bind(_cards(["hostA", "hostB"]), 0)
        tpl = btl_comps.plan_frame_template((8,), "float32", seg)
        with pytest.raises(MPIError) as ei:
            for _ in mod.frame_stream(_CaptureEp(), 1, USER_TAG + 1,
                                      np.zeros(9, np.float32), tpl=tpl):
                pass
        assert ei.value.code == ErrorCode.ERR_INTERN


def _pair(a_cls, b_cls):
    a, b = a_cls(1), b_cls(2)
    b.connect(1, "127.0.0.1", a.port)
    return a, b


def _port_ep(nid):
    from ompi_release_tpu_torch.native import OobEndpoint

    return OobEndpoint(nid, secret=b"")


def _jax_ep(nid):
    from ompi_release_tpu.native import OobEndpoint

    return OobEndpoint(nid, secret=b"")


class TestSocketInterop:
    @pytest.mark.parametrize("seg", [1 << 16], indirect=True)
    @pytest.mark.parametrize("receiver", ["port", "jax"])
    def test_native_sender_portable_receiver(self, seg, receiver):
        """The port's native sender; the port's or the JAX package's
        portable staged receiver on the other end of a real socket."""
        a, b = _pair(_port_ep if receiver == "port" else _jax_ep,
                     _port_ep)
        try:
            mod = nw.NativeWireBtl()
            mod.bind(_cards(["hostA", "hostB"]), 1)  # sender is pidx 1
            x = np.random.default_rng(1).standard_normal(
                300_000).astype(np.float32)
            mod.send_staged(b, 1, USER_TAG + 3, x)
            rx = btl_comps.DcnBtl() if receiver == "port" \
                else jbtl.DcnBtl()
            got = rx.recv_staged(a, USER_TAG + 3)
            assert np.asarray(got).tobytes() == x.tobytes()
        finally:
            a.close()
            b.close()

    @pytest.mark.parametrize("seg", [1 << 16], indirect=True)
    @pytest.mark.parametrize("sender", ["port", "jax"])
    def test_portable_sender_native_receiver(self, seg, sender):
        a, b = _pair(_port_ep,
                     _port_ep if sender == "port" else _jax_ep)
        try:
            mod = nw.NativeWireBtl()
            mod.bind(_cards(["hostA", "hostB"]), 0)  # receiver pidx 0
            before = nw._native_bytes.read()
            x = np.random.default_rng(2).integers(
                -2**30, 2**30, 123_457).astype(np.int32)
            if sender == "port":
                btl_comps.DcnBtl().send_staged(b, 1, USER_TAG + 4, x)
            else:
                jbtl.mca_var.set_value("wire_pipeline_segsize",
                                       str(1 << 16))
                try:
                    jbtl.DcnBtl().send_staged(b, 1, USER_TAG + 4, x)
                finally:
                    jbtl.mca_var.VARS.unset("wire_pipeline_segsize")
            got = mod.recv_staged(a, USER_TAG + 4)
            assert isinstance(got, torch.Tensor)
            assert got.numpy().tobytes() == x.tobytes()
            assert nw._native_bytes.read() - before == x.nbytes
        finally:
            a.close()
            b.close()

    @pytest.mark.parametrize("seg", [1 << 14], indirect=True)
    def test_crc_catches_corruption(self, seg):
        """A corrupted fragment payload fails the transfer CRC with the
        typed ERR_TRUNCATE — never silently wrong data."""
        a, b = _pair(_port_ep, _port_ep)
        try:
            mod = nw.NativeWireBtl()
            mod.bind(_cards(["hostA", "hostB"]), 0)
            x = np.arange(20_000, dtype=np.int32)
            frames = list(btl_comps.DcnBtl().staged_frames(x, segsize=seg))
            bad = bytearray(frames[-1])
            bad[-1] ^= 0xFF
            frames[-1] = bytes(bad)
            for fr in frames:
                b.send(1, USER_TAG + 6, fr)
            with pytest.raises(MPIError) as ei:
                mod.recv_staged(a, USER_TAG + 6, timeout_ms=10_000)
            assert ei.value.code == ErrorCode.ERR_TRUNCATE
        finally:
            a.close()
            b.close()

    @pytest.mark.parametrize("seg", [1 << 15], indirect=True)
    def test_shm_ring_loopback_same_process(self, seg):
        """Co-hosted mode in one process: fragments cross a real
        /dev/shm ring while the header rides the OOB; a clean host
        payload forces no copy."""
        a, b = _pair(_port_ep, _port_ep)
        cards = _cards(["hostX", "hostX"])  # SAME host: ring mode
        tx, rx = nw.NativeWireBtl(), nw.NativeWireBtl()
        tx.bind(cards, 1)
        rx.bind(cards, 0)
        try:
            x = np.random.default_rng(4).standard_normal(
                500_000).astype(np.float32)
            b_fb = nw._fallback_copies.read()
            b_nb = nw._native_bytes.read()
            err = []

            def _send():
                try:
                    tx.send_staged(b, 1, USER_TAG + 8, x)
                except Exception as e:  # surfaced by the main thread
                    err.append(e)

            th = threading.Thread(target=_send, daemon=True)
            th.start()
            got = rx.recv_staged(a, USER_TAG + 8, timeout_ms=60_000)
            th.join(timeout=60)
            assert not err, err
            assert got.numpy().tobytes() == x.tobytes()
            assert nw._native_bytes.read() - b_nb == 2 * x.nbytes
            assert nw._fallback_copies.read() == b_fb
        finally:
            a.close()
            b.close()
            tx._shutdown_rings()
            rx._shutdown_rings()
        token = cards[0][nw.CARD_KEY].split(":")[0]
        assert not glob.glob(f"/dev/shm/onw-{token}-*")

    @staticmethod
    def _small_ring_pair():
        """Two co-hosted modules whose rings hold 64 KiB (the floor of
        a card's geometry) over a real socket pair."""
        a, b = _pair(_port_ep, _port_ep)
        cards = _cards(["hostX", "hostX"])
        for c in cards:
            c[nw.CARD_KEY] = c[nw.CARD_KEY].rsplit(":", 1)[0] + ":65536"
        m0, m1 = nw.NativeWireBtl(), nw.NativeWireBtl()
        m0.bind(cards, 0)
        m1.bind(cards, 1)
        return (m0, a), (m1, b)

    @staticmethod
    def _exchange(ends, payloads, tag, delay=(0.0, 0.0)):
        """Each end sends its payloads back to back on ``tag``, then
        (after its ``delay``) receives as many; returns each end's
        received tensors, in order."""
        got, err = {0: [], 1: []}, []

        def side(k):
            mod, ep = ends[k]
            try:
                for x in payloads[k]:
                    mod.send_staged(ep, 2 - k, tag, x)
                time.sleep(delay[k])
                for _ in payloads[1 - k]:
                    got[k].append(mod.recv_staged(ep, tag,
                                                  timeout_ms=60_000))
            except Exception as e:  # surfaced by the main thread
                err.append(e)

        ts = [threading.Thread(target=side, args=(k,)) for k in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts), "the exchange hung"
        assert not err, err
        return got

    @pytest.mark.parametrize("seg", [1 << 14], indirect=True)
    def test_both_ends_sending_through_full_rings_complete(self, seg):
        """Two co-hosted senders that each post a transfer larger than
        the ring before receiving (every exchange round of the hier
        schedules): the rings fill, each sender reaps its own receive
        ring into the stash while it waits, and both transfers arrive
        whole — found on the card, where a 64 MiB spanning allreduce
        had both workers waiting on full rings."""
        ends = self._small_ring_pair()
        rng = np.random.default_rng(9)
        x0 = rng.standard_normal(1 << 19).astype(np.float32)  # 2 MiB
        x1 = rng.standard_normal(1 << 19).astype(np.float32)
        r0 = nw._reaped_bytes.read()
        try:
            got = self._exchange(ends, ([x0], [x1]), USER_TAG + 12)
            assert got[0][0].numpy().tobytes() == x1.tobytes()
            assert got[1][0].numpy().tobytes() == x0.tobytes()
            assert nw._reaped_bytes.read() > r0
        finally:
            for mod, ep in ends:
                ep.close()
                mod._shutdown_rings()

    @pytest.mark.parametrize("seg", [1 << 14], indirect=True)
    @pytest.mark.parametrize("slow", [0, 1])
    def test_back_to_back_transfers_on_one_tag_keep_their_order(
            self, seg, slow):
        """Two transfers per end, back to back on ONE tag (the
        collective channel's tag is shared by every array and round),
        through 64 KiB rings with one receiver slowed: every fragment
        of every transfer rides the ring (no fragment on the socket),
        so the second transfer can never overtake the first."""
        ends = self._small_ring_pair()
        rng = np.random.default_rng(10 + slow)
        xs = [[rng.standard_normal(1 << 18).astype(np.float32)
               for _ in range(2)] for _ in range(2)]  # 1 MiB each
        delay = [0.0, 0.0]
        delay[slow] = 0.3
        tx0 = [ep.wire_stats()["tx_frames"] for _mod, ep in ends]
        try:
            got = self._exchange(ends, xs, USER_TAG + 13, tuple(delay))
            for k in (0, 1):
                assert [g.numpy().tobytes() for g in got[k]] == \
                    [x.tobytes() for x in xs[1 - k]]
            assert [ep.wire_stats()["tx_frames"]
                    for _mod, ep in ends] == tx0
        finally:
            for mod, ep in ends:
                ep.close()
                mod._shutdown_rings()

    @pytest.mark.parametrize("seg", [1 << 14], indirect=True)
    def test_full_ring_wait_stops_when_the_collective_is_revoked(self, seg):
        """A collective send parked on a full ring toward a LIVE peer
        that stopped draining (it left the round to recover from a third
        process's failure) raises ERR_REVOKED within a check slice of
        the revoke, not after the 30 s ring timeout — found on the card,
        where a survivor of a killed worker waited out the 30 s and
        failed its recovery with ERR_PENDING."""
        from ompi_release_tpu_torch.ft import ulfm
        from ompi_release_tpu_torch.runtime.wire import WIRE_COLL_BASE

        cid = 4242
        ends = self._small_ring_pair()
        x = np.random.default_rng(15).standard_normal(
            1 << 19).astype(np.float32)  # 2 MiB through a 64 KiB ring
        err, done = [], []
        mod, ep = ends[0]

        def _send():
            try:
                mod.send_staged(ep, 2, WIRE_COLL_BASE + cid, x)
            except MPIError as e:
                err.append(e)
            done.append(time.monotonic())

        th = threading.Thread(target=_send, daemon=True)
        try:
            th.start()
            time.sleep(0.5)
            assert th.is_alive() and not err, "the ring never filled"
            t_revoke = time.monotonic()
            ulfm.STATE.apply_revoke(cid)
            th.join(timeout=10)
            assert not th.is_alive(), "the revoke did not end the wait"
            assert err and err[0].code == ErrorCode.ERR_REVOKED, err
            assert done[0] - t_revoke < 2.0
        finally:
            ulfm.STATE.clear_revoked(cid)
            for m, e in ends:
                e.close()
                m._shutdown_rings()

    @pytest.mark.parametrize("seg", [1 << 17], indirect=True)
    def test_fragment_larger_than_the_ring_rides_the_socket(self, seg):
        """A transfer whose fragment record cannot fit the receiver's
        ring rides the vectored socket whole, and both ends agree."""
        ends = self._small_ring_pair()
        x = np.random.default_rng(12).standard_normal(
            1 << 17).astype(np.float32)  # 512 KiB: 4 fragments
        tx0 = ends[0][1].wire_stats()["tx_frames"]
        try:
            got = self._exchange(ends, ([x], []), USER_TAG + 14)
            assert got[1][0].numpy().tobytes() == x.tobytes()
            assert ends[0][1].wire_stats()["tx_frames"] - tx0 == 4
        finally:
            for mod, ep in ends:
                ep.close()
                mod._shutdown_rings()

    def test_release_waits_for_unattached_consumer(self):
        """A completed send whose receiver has not attached yet survives
        the producer's release: the unlink waits until a consumer maps
        the ring, then finishes promptly."""
        from ompi_release_tpu_torch.native import ShmRing

        tx = nw.NativeWireBtl()
        tx.bind(_cards(["hostX", "hostX"]), 1)
        ring, _lk = tx._tx_ring(0, 3)
        payload = np.arange(4096, dtype=np.int32).tobytes()
        assert ring.writev(177, [payload], 2000) == 0
        name = nw._ring_name(tx._cap(0)[0], 1, 3)
        th = threading.Thread(target=tx._shutdown_rings, daemon=True)
        th.start()
        time.sleep(0.25)
        assert th.is_alive(), \
            "release unlinked a ring still holding undelivered bytes"
        late = ShmRing.attach(name, os.getpid())
        assert late is not None, "ring name vanished before attach"
        try:
            th.join(timeout=10)
            assert not th.is_alive(), "release ignored the attach"
            buf = bytearray(len(payload))
            rc, tag = late.read_into(buf, 2000)
            assert rc >= 0 and tag == 177 and bytes(buf) == payload
        finally:
            late.close()
            ShmRing.unlink(name)


class TestSelectionAndFallback:
    def test_component_registered_at_package_import(self):
        out = subprocess.check_output(
            [sys.executable, "-c", textwrap.dedent(f"""
                import sys; sys.path.insert(0, {REPO!r})
                from ompi_release_tpu_torch.btl import BTL_FRAMEWORK
                print([c.NAME for c in BTL_FRAMEWORK.components()])
            """)])
        assert b"nativewire" in out

    @pytest.mark.parametrize("how", ["env", "cvar"])
    def test_kill_switch_withdraws_component(self, how, monkeypatch):
        """OMPITPU_NATIVEWIRE=0 and btl_nativewire_enable=false each
        withdraw the component: no card, no module, query None."""
        if how == "env":
            monkeypatch.setenv("OMPITPU_NATIVEWIRE", "0")
        else:
            mca_var.set_value("btl_nativewire_enable", "false")
        try:
            assert not nw.nativewire_ready()
            assert nw.modex_entry() == {}
            assert nw.NativeWireComponent().query() is None
            assert nw.module_for(_cards(["h", "h"]), 0) is None
        finally:
            if how == "cvar":
                mca_var.VARS.unset("btl_nativewire_enable")
        if how == "cvar":
            assert nw.nativewire_ready()  # unset restores the default

    def test_capability_probes_find_the_built_library(self):
        """The three never-raising probes of the optional datapath ABI
        see the port's build of native/ (the .so carries all three)."""
        from ompi_release_tpu_torch.native import (
            planexec_symbols_available, telemetry_symbols_available,
            wire_symbols_available)

        assert wire_symbols_available()
        assert telemetry_symbols_available()
        assert planexec_symbols_available()

    def test_component_selected_when_ready(self):
        prio, mod = nw.NativeWireComponent().query()
        assert prio == 45 and mod.NAME == "nativewire"

    def test_modex_card_roundtrip(self):
        """The card's token, slots and ring size parse back; the JAX
        package's parser reads the port's card the same way."""
        from ompi_release_tpu.btl import nativewire as jnw

        entry = nw.modex_entry()
        assert set(entry) == {nw.CARD_KEY} and nw.CARD_KEY == jnw.CARD_KEY
        token, slots, ring = nw._parse_card(entry[nw.CARD_KEY])
        assert token == nw._local_token()
        assert (token, slots, ring) == jnw._parse_card(entry[nw.CARD_KEY])
        assert slots >= 1 and ring >= 1 << 16

    @pytest.mark.parametrize("card", ["garbage", None, "", "t:0:1"])
    def test_parse_card_matches_the_jax_package(self, card):
        from ompi_release_tpu.btl import nativewire as jnw

        assert nw._parse_card(card) == jnw._parse_card(card)
        if card == "t:0:1":  # floors: clamped, not trusted
            assert nw._parse_card(card) == ("t", 1, 1 << 16)

    def test_peer_capable_is_both_ended_and_live(self):
        cards = _cards(["h", "h", "h"], capable={0, 1})
        mod = nw.NativeWireBtl()
        mod.bind(cards, 0)
        assert mod.peer_capable(1)
        assert not mod.peer_capable(2)   # peer never advertised
        assert not mod.peer_capable(0)   # self is never a wire peer
        cards[1][nw.CARD_KEY] = f"fresh:2:{1 << 20}"
        assert mod.peer_capable(1) and mod._cap(1)[0] == "fresh"
        del cards[1][nw.CARD_KEY]
        assert not mod.peer_capable(1)
        own = nw.NativeWireBtl()
        own.bind(_cards(["h", "h"], capable={1}), 0)
        assert not own.peer_capable(1)  # we never advertised

    def test_slot_hash_matches_the_jax_package(self):
        from ompi_release_tpu.btl import nativewire as jnw

        tags = [USER_TAG + lane * LANE_STRIDE + 5 for lane in range(4)]
        assert len({nw._slot_of(t, 4) for t in tags}) > 1
        for t in tags + [USER_TAG + 123456, 3 << 20]:
            for slots in (1, 2, 4):
                assert nw._slot_of(t, slots) == jnw._slot_of(t, slots)
        assert nw._ring_name("tk", 2, 1) == jnw._ring_name("tk", 2, 1)

    def test_host_array_copy_accounting(self):
        arr = np.arange(32, dtype=np.float32)
        out, name, copied = nw._host_array(arr)
        assert out is arr and name == "float32" and not copied
        out, _, copied = nw._host_array(arr[::2])  # non-contiguous
        assert copied and out.flags["C_CONTIGUOUS"]
        t = torch.arange(8, dtype=torch.float32)
        out, _, copied = nw._host_array(t)
        assert not copied and np.shares_memory(out, t.numpy())
        out, name, copied = nw._host_array(t.to(torch.bfloat16))
        assert name == "bfloat16" and out.dtype == np.uint16
        _, _, copied = nw._host_array(t[::2])
        assert copied

    @pytest.mark.parametrize("seg", [1024], indirect=True)
    def test_incapable_peer_rides_portable_framing(self, seg):
        mod = nw.NativeWireBtl()
        mod.bind(_cards(["hostA", "hostB"], capable={0}), 0)
        x = np.arange(2048, dtype=np.int16)

        def native():
            ep = _CaptureEp()
            for _ in mod.frame_stream(ep, 1, USER_TAG + 2, x):
                pass
            return ep.frames

        got = _with_xfer(31, native)
        ref = _with_xfer(31, lambda: list(
            btl_comps.DcnBtl().staged_frames(x, segsize=seg)))
        assert got == ref

    def test_gc_inside_ring_registration_does_not_hang(self):
        """A garbage collection that releases a collected module's rings
        while another ring is being registered (the telemetry lock held
        on this thread) must re-enter the lock, not deadlock on it."""
        done = threading.Event()
        errors = []
        released = []

        class CollectingSet(set):
            def add(self, item):
                gc.collect()  # runs the cycle's finalizer right here
                super().add(item)

        def run():
            saved = nw._live_tx
            try:
                nw._live_tx = CollectingSet()
                for i in range(3):
                    cyc = nw.NativeWireBtl()
                    cyc.bind(_cards(["hostX", "hostX"]), 1)
                    cyc._tx_ring(0, i)
                    cyc.me = cyc  # collectable only by the cycle GC
                    released.append(weakref.ref(cyc))
                    del cyc
                    fresh = nw.NativeWireBtl()
                    fresh.bind(_cards(["hostX", "hostX"]), 1)
                    fresh._tx_ring(0, 3)  # registration collects it
                    fresh._shutdown_rings()
            except Exception as e:  # surfaced below
                errors.append(e)
            finally:
                nw._live_tx = saved
                done.set()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        assert done.wait(30), "ring registration hung in a GC finalizer"
        assert not errors, errors
        assert all(r() is None for r in released)


# ---------------------------------------------------------------------------
# real multi-process jobs of the port
# ---------------------------------------------------------------------------

APP_PRELUDE = textwrap.dedent("""
    import os, sys, time
    sys.path.insert(0, %r)
    import numpy as np
    import torch
    import ompi_release_tpu_torch as mpi
    from ompi_release_tpu_torch.mca import pvar
    from ompi_release_tpu_torch.runtime.runtime import Runtime

    def init():
        return mpi.init(cli_args=["--mca", "runtime_virtual_ranks", "2"],
                        device="cpu")
""" % REPO)


def _run_job(tmp_path, capfd, body, *, n=3, timeout=180, name="nw_app"):
    app = tmp_path / f"{name}.py"
    app.write_text(APP_PRELUDE + textwrap.dedent(body))
    job = Job(n, [sys.executable, str(app)], [], heartbeat_s=0.5,
              miss_limit=8)
    rc = job.run(timeout_s=timeout)
    out = capfd.readouterr()
    return rc, out.out + out.err, job


PARITY_BODY = """
world = init()
rt = Runtime.current()
me = rt.bootstrap["process_index"]
n = world.size
off = rt.local_rank_offset
assert rt.wire._nw is not None, "native datapath did not come up"
for p in range(3):
    if p != me:
        assert rt.wire._btl_for(p).NAME == "nativewire"
nb = pvar.PVARS.lookup("wire_native_bytes")
x = np.stack([np.arange(64, dtype=np.int32) * (off + i + 1)
              for i in range(2)])
want = sum(np.arange(64, dtype=np.int32) * (r + 1) for r in range(n))
for _ in range(3):  # record, then replay the frozen plan twice
    got = world.allreduce(x).numpy()
    for i in range(2):
        np.testing.assert_array_equal(got[i], want)
bx = (np.stack([np.arange(1024, dtype=np.int32) * 3] * 2) if off == 0
      else np.zeros((2, 1024), np.int32))
bgot = world.bcast(bx, root=0).numpy()
np.testing.assert_array_equal(bgot[0], np.arange(1024, dtype=np.int32) * 3)
rs = np.stack([np.arange(n * 8, dtype=np.int32) + 10 * (off + i)
               for i in range(2)])
rgot = world.reduce_scatter_block(rs).numpy()
want_full = sum(np.arange(n * 8, dtype=np.int32) + 10 * r
                for r in range(n))
for i in range(2):
    r = off + i
    np.testing.assert_array_equal(rgot[i], want_full[r * 8:(r + 1) * 8])
ag = world.allgather(np.stack([np.full(4, off + i, np.int32)
                               for i in range(2)])).numpy()
np.testing.assert_array_equal(ag[0].reshape(n, 4)[:, 0],
                              np.arange(n, dtype=np.int32))
if me == 0:
    world.send(np.arange(50_000, dtype=np.float32), n - 1, tag=21, rank=0)
elif me == 2:
    val, st = world.recv(source=0, tag=21, rank=n - 1)
    np.testing.assert_array_equal(val.numpy(),
                                  np.arange(50_000, dtype=np.float32))
world.barrier()
assert float(nb.read()) > 0, "no bytes rode the native datapath"
assert float(pvar.PVARS.lookup("wire_native_fallback_copies").read()) == 0
print(f"NW_PARITY_OK {me}", flush=True)
mpi.finalize()
"""


class TestNativeJobs:
    @pytest.mark.parametrize("mode", ["shm", "tcp"])
    def test_collectives_and_p2p_over_native_3proc(self, tmp_path, capfd,
                                                   mode):
        """3 processes: every cross-process byte rides the shm rings
        (one host) or the vectored sockets (a host id per worker); the
        families check bitwise and the native byte counter moves; no
        ring outlives the job."""
        pre = "" if mode == "shm" else textwrap.dedent("""
            os.environ["OMPITPU_HOST_ID"] = (
                "nwhost-" + os.environ["OMPITPU_NODE_ID"])
        """)
        before = set(glob.glob("/dev/shm/onw-*"))
        rc, out, job = _run_job(tmp_path, capfd, pre + PARITY_BODY)
        assert rc == 0, out
        for me in range(3):
            assert f"NW_PARITY_OK {me}" in out, out
        assert job.job_state.visited(JobState.TERMINATED)
        # this job's rings (named by their owner's pid): other test
        # files' jobs, running at the same time, make and free their own
        owners = tuple(f"/dev/shm/onw-{p.pid:x}-"
                       for p in job.procs.values())
        left = {r for r in set(glob.glob("/dev/shm/onw-*")) - before
                if r.startswith(owners)}
        assert not left

    def test_mixed_fleet_per_peer_fallback(self, tmp_path, capfd):
        """One worker opts out (OMPITPU_NATIVEWIRE=0): capable pairs
        keep the native path, pairs touching the opted-out worker fall
        back per peer, and the world still checks bitwise."""
        rc, out, _job = _run_job(tmp_path, capfd, """
if os.environ["OMPITPU_NODE_ID"] == "3":
    os.environ["OMPITPU_NATIVEWIRE"] = "0"
world = init()
rt = Runtime.current()
me = rt.bootstrap["process_index"]
n = world.size
off = rt.local_rank_offset
if me == 2:
    assert rt.wire._nw is None
    for p in (0, 1):
        assert rt.wire._btl_for(p).NAME == "shm"
else:
    nw = rt.wire._nw
    other = 1 - me
    assert nw.peer_capable(other) and not nw.peer_capable(2)
    assert rt.wire._btl_for(other).NAME == "nativewire"
    assert rt.wire._btl_for(2).NAME == "shm"
x = np.stack([np.arange(32, dtype=np.int32) * (off + i + 1)
              for i in range(2)])
want = sum(np.arange(32, dtype=np.int32) * (r + 1) for r in range(n))
for _ in range(2):
    np.testing.assert_array_equal(world.allreduce(x).numpy()[0], want)
if me == 0:
    world.send(np.arange(9999, dtype=np.int32), n - 1, tag=23, rank=0)
elif me == 2:
    val, st = world.recv(source=0, tag=23, rank=n - 1)
    np.testing.assert_array_equal(val.numpy(),
                                  np.arange(9999, dtype=np.int32))
world.barrier()
print(f"NW_MIXED_OK {me}", flush=True)
mpi.finalize()
""")
        assert rc == 0, out
        for me in range(3):
            assert f"NW_MIXED_OK {me}" in out, out
