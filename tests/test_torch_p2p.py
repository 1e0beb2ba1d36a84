"""Point-to-point of the PyTorch port held against the JAX package.

The same send/recv/probe/wait sequences go through the JAX package's
communicator on its 8-device virtual CPU mesh and through the port's
with 8 virtual ranks on the CPU. Each sequence records what a program
sees: received values (dtype, shape and bytes: bitwise), ``Status``
(source, tag, count, cancelled), completion flags, PML queue depths,
pvar deltas and error codes. The two records must be equal. Inputs are
32-bit (made with numpy from a seed where random): the JAX package runs
without x64 and would narrow 64-bit payloads.

Covered: the in-process cases of ``tests/test_p2p.py`` (ring_c parity,
static ring shift, matching, protocols, requests) plus matched probes,
queue dumps, payload type errors and ``wait_some``. The nbc, vprotocol
and dp cases belong to later slices.
"""

import concurrent.futures
import gc
import os
import pathlib
import subprocess
import sys
import threading
import types

import numpy as np
import pytest
import torch

import jax
import ompi_release_tpu as jmpi
from ompi_release_tpu.request import request as jreq
from ompi_release_tpu.mca import pvar as jpvar
from ompi_release_tpu.mca import var as jvar
from ompi_release_tpu.p2p import spmd as jspmd
from ompi_release_tpu.utils.errors import MPIError as JMPIError
import ompi_release_tpu_torch as tmpi
from ompi_release_tpu_torch.request import request as treq
from ompi_release_tpu_torch.mca import pvar as tpvar
from ompi_release_tpu_torch.mca import var as tvar
from ompi_release_tpu_torch.p2p import spmd as tspmd
from ompi_release_tpu_torch.runtime import runtime as trt
from ompi_release_tpu_torch.utils.errors import MPIError as TMPIError

N = 8
REPO = pathlib.Path(__file__).resolve().parent.parent
JAX = types.SimpleNamespace(req=jreq, var=jvar, pvar=jpvar, err=JMPIError)
PORT = types.SimpleNamespace(req=treq, var=tvar, pvar=tpvar, err=TMPIError)


@pytest.fixture(scope="module")
def worlds():
    jworld = jmpi.init()
    trt._reset_for_tests()
    tworld = tmpi.init(cli_args=["--mca", "runtime_virtual_ranks", str(N)],
                       device="cpu")
    assert jworld.size == tworld.size == N
    yield jworld, tworld
    trt._reset_for_tests()
    tvar.VARS.unset("runtime_virtual_ranks")


@pytest.fixture(autouse=True)
def _no_collection_inside_the_shm_btl_lock():
    """The JAX package's ShmBtl registers each instance under a plain
    lock (``ompi_release_tpu/btl/components.py:827``). A garbage
    collection that starts inside it finalizes an older instance, whose
    finalizer takes the same lock (``:799``), and the process hangs.
    Collect first, then keep the collector off while a case runs (an
    instance freed by its refcount is finalized outside the lock)."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def val(v):
    """A received value as (dtype, shape, bytes)."""
    a = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return (a.dtype.str, a.shape, a.tobytes())


def st(s):
    return None if s is None else (s.source, s.tag, s.count, s.cancelled)


def err(pkg, fn):
    """The MPI error class ``fn`` raises (its name), or None."""
    try:
        fn()
    except pkg.err as e:
        return e.code.name
    return None


def pvar_delta(pkg, name, fn):
    before = pkg.pvar.PVARS.lookup(name).read()
    fn()
    return pkg.pvar.PVARS.lookup(name).read() - before


class cvars:
    """Set cvars in one package's registry for a block."""

    def __init__(self, pkg, **kv):
        self.pkg, self.kv = pkg, kv

    def __enter__(self):
        for k, v in self.kv.items():
            self.pkg.var.set_value(k, v)

    def __exit__(self, *exc):
        for k in self.kv:
            self.pkg.var.VARS.unset(k)


# ---------------------------------------------------------------------------
# sequences: each takes (comm, pkg) and returns what the program saw
# ---------------------------------------------------------------------------

def ring_c(c, pkg):
    """examples/ring_c.c with 4 virtual ranks: every rank loops
    recv-from-prev / forward-to-next (rank 0 decrements per lap), exits
    after forwarding a 0; rank 0 drains the final 0."""
    n, laps = 4, 3
    sub = c.create(c.group.incl(list(range(n))), name="ring4")
    sub.send(np.int32(laps), dest=1, tag=201, rank=0)
    done, seen = [False] * n, []
    for _ in range(10 * n * (laps + 2)):  # bounded: fail, don't hang
        if all(done):
            break
        for r in range(n):
            if done[r]:
                continue
            if sub.iprobe(source=(r - 1) % n, tag=201, rank=r) is None:
                continue
            value, status = sub.recv(source=(r - 1) % n, tag=201, rank=r)
            seen.append((r, val(value), st(status)))
            value = int(value) - (1 if r == 0 else 0)
            sub.send(np.int32(value), dest=(r + 1) % n, tag=201, rank=r)
            if value == 0:
                done[r] = True
    v, s = sub.recv(source=n - 1, tag=201, rank=0)
    seen.append((0, val(v), st(s)))
    depth = sub.pml.pending_counts()
    sub.free()
    return done, seen, depth


def unexpected_queue(c, pkg):
    c.send(np.float32(1.5), dest=2, tag=7, rank=0)
    depth = c.pml.pending_counts()
    probe = st(c.iprobe(source=0, tag=7, rank=2))
    v, s = c.recv(source=0, tag=7, rank=2)
    return depth, probe, val(v), st(s), c.pml.pending_counts()


def recv_before_send(c, pkg):
    r = c.irecv(source=3, tag=9, rank=1)
    before = (r.is_complete, c.pml.pending_counts())
    c.send(np.arange(4, dtype=np.float32), dest=1, tag=9, rank=3)
    s = r.wait()
    return before, val(r.value), st(s), c.pml.pending_counts()


def wildcards(c, pkg):
    c.send(np.int32(42), dest=5, tag=33, rank=4)
    v, s = c.recv(source=-1, tag=-1, rank=5)
    c.send(np.int32(43), dest=5, tag=34, rank=6)
    r = c.irecv(source=6, tag=-1, rank=5)
    return val(v), st(s), val(r.value), st(r.wait())


def ordering(c, pkg):
    """Same (src, tag) arrives in order; ANY_SOURCE takes the oldest."""
    for i in range(3):
        c.send(np.int32(i), dest=6, tag=1, rank=0)
    c.send(np.int32(9), dest=6, tag=1, rank=3)
    got = [c.recv(source=0, tag=1, rank=6) for _ in range(2)]
    rest = [c.recv(source=-1, tag=1, rank=6) for _ in range(2)]
    return [(val(v), st(s)) for v, s in got + rest]


def tag_selectivity(c, pkg):
    c.send(np.int32(10), dest=7, tag=100, rank=1)
    c.send(np.int32(20), dest=7, tag=200, rank=1)
    a = c.recv(source=1, tag=200, rank=7)
    depth = c.pml.pending_counts()
    b = c.recv(source=1, tag=100, rank=7)
    return [(val(v), st(s)) for v, s in (a, b)], depth


def probe(c, pkg):
    c.send(np.arange(6, dtype=np.int32).reshape(2, 3), dest=3, tag=55,
           rank=2)
    p1 = st(c.iprobe(source=2, tag=55, rank=3))
    p2 = st(c.iprobe(source=-1, tag=-1, rank=3))
    miss = st(c.iprobe(source=2, tag=56, rank=3))
    v, s = c.recv(source=2, tag=55, rank=3)
    return p1, p2, miss, val(v), st(s), st(c.iprobe(source=2, tag=55,
                                                    rank=3))


def matched_probe(c, pkg):
    c.send(np.arange(5, dtype=np.float32) * 2, dest=0, tag=6, rank=1)
    c.send(np.float32(7), dest=0, tag=6, rank=2)
    msg = c.pml.improbe(source=-1, tag=6, dst=0)
    # a wildcard recv cannot steal the probed message
    v2, s2 = c.recv(source=-1, tag=6, rank=0)
    v1, s1 = c.pml.mrecv(msg, dst=0)
    none = c.pml.improbe(source=-1, tag=6, dst=0)
    return val(v1), st(s1), val(v2), st(s2), none is None


def bad_rank(c, pkg):
    return (err(pkg, lambda: c.send(np.int32(0), dest=c.size + 3, rank=0)),
            err(pkg, lambda: c.irecv(source=-2, rank=0)),
            err(pkg, lambda: c.irecv(source=0, rank=c.size)))


def payload_type(c, pkg):
    rec = np.zeros(2, dtype=[("a", np.int32), ("b", np.float32)])
    out = []
    for data in (np.array(["ab", "c"]), rec):
        try:
            c.send(data, dest=1, rank=0)
            out.append(None)
        except pkg.err as e:
            out.append((e.code.name, str(e).split(" (")[0]))
    return out, c.pml.pending_counts()


def eager(c, pkg):
    req = c.isend(np.zeros(8, np.float32), dest=1, tag=71, rank=0)
    done = req.is_complete  # under the eager limit: done at once
    dump = c.pml.dump_queues()
    v, s = c.recv(source=0, tag=71, rank=1)
    return done, st(req.status), dump, val(v), st(s)


def rendezvous(c, pkg):
    with cvars(pkg, pml_eager_limit=16):
        req = c.isend(np.arange(100, dtype=np.float32), dest=1, tag=72,
                      rank=0)
        before = (req.is_complete, req.test()[0])
        dump = c.pml.dump_queues()
        v, s = c.recv(source=0, tag=72, rank=1)
        return before, dump, req.is_complete, st(req.wait()), val(v), st(s)


def pipelined(c, pkg):
    data = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    out = {}
    with cvars(pkg, pml_max_send_size=256):  # force segmentation
        def run():
            c.send(data, dest=2, tag=73, rank=1)
            out["recv"] = c.recv(source=1, tag=73, rank=2)
        moves = pvar_delta(pkg, "pml_pipelined_sends", run)
        self_moves = pvar_delta(  # the override applies to self-sends too
            pkg, "pml_pipelined_sends",
            lambda: c.sendrecv([data] * N, list(range(N)), sendtag=74,
                               recvtag=74))
    v, s = out["recv"]
    return moves, self_moves, val(v), st(s)


def protocol_counters(c, pkg):
    big = np.ones((1 << 20) // 4 + 1, np.float32)  # 1 MiB + 4 B: rndv
    counts = {}
    for name, fn in (
            ("pml_eager_sends",
             lambda: c.send(np.ones(4, np.float32), dest=1, tag=3, rank=0)),
            ("pml_rndv_sends", lambda: c.send(big, dest=1, tag=4, rank=0)),
            ("pml_unexpected_msgs",
             lambda: c.send(np.int32(1), dest=1, tag=5, rank=0))):
        counts[name] = pvar_delta(pkg, name, fn)
    dump = c.pml.dump_queues()
    got = [val(c.recv(source=0, tag=t, rank=1)[0]) for t in (3, 4, 5)]
    return counts, dump, got[:1] + got[2:], got[1][:2]


def ssend_rsend(c, pkg):
    req = c.isend(np.int32(1), dest=4, tag=74, rank=3, sync=True)
    before = req.is_complete
    c.recv(source=3, tag=74, rank=4)
    rs = err(pkg, lambda: c.isend(np.int32(1), dest=5, tag=75, rank=4,
                                  ready=True))
    r = c.irecv(source=4, tag=76, rank=5)
    c.isend(np.int32(9), dest=5, tag=76, rank=4, ready=True)
    ss = err(pkg, lambda: c.send(np.int32(2), dest=6, tag=77, rank=4,
                                 sync=True))
    return before, req.is_complete, rs, val(r.value), ss, \
        c.pml.pending_counts()


def sendrecv(c, pkg):
    values, statuses = c.sendrecv(
        [np.int32(r) for r in range(N)], [(r + 1) % N for r in range(N)],
        sendtag=77, sources=[(r - 1) % N for r in range(N)], recvtag=77)
    bad = err(pkg, lambda: c.sendrecv([np.int32(0)], [1]))
    return [val(v) for v in values], [st(s) for s in statuses], bad


def waitall_testall(c, pkg):
    rs = [c.irecv(source=0, tag=80 + i, rank=1) for i in range(3)]
    early = pkg.req.test_all(rs)
    for i in range(3):
        c.send(np.int32(i), dest=1, tag=80 + i, rank=0)
    done, sts = pkg.req.test_all(rs)
    sts2 = pkg.req.wait_all(rs)
    return early, done, [st(s) for s in sts], [st(s) for s in sts2], \
        [val(r.value) for r in rs]


def waitany_waitsome(c, pkg):
    rs = [c.irecv(source=0, tag=90 + i, rank=2) for i in range(3)]
    none = pkg.req.test_any(rs)
    c.send(np.int32(7), dest=2, tag=91, rank=0)
    i, s = pkg.req.wait_any(rs)
    c.send(np.int32(8), dest=2, tag=90, rank=0)
    c.send(np.int32(9), dest=2, tag=92, rank=0)
    idx, sts = pkg.req.wait_some(rs)
    return none, i, st(s), idx, [st(x) for x in sts], \
        [val(r.value) for r in rs]


def persistent(c, pkg):
    sreq = c.pml.send_init(np.int32(3), 1, tag=95, src=0)
    rreq = c.pml.recv_init(source=0, tag=95, dst=1)
    out = [rreq.test(), rreq.is_complete]
    for _ in range(3):
        rreq.start()
        out.append(rreq.is_complete)
        sreq.start()
        out += [st(rreq.wait()), val(rreq.value), st(sreq.wait())]
    out.append(err(pkg, lambda: c.isend(np.int32(0), 1, rank=0).start()))
    active = c.pml.recv_init(source=0, tag=96, dst=1).start()
    out.append(err(pkg, active.start))
    active.cancel()
    return out


def wait_without_match(c, pkg):
    r = c.irecv(source=0, tag=999, rank=3)
    code = err(pkg, r.wait)
    depth = c.pml.pending_counts()
    r.cancel()
    return code, depth, st(r.wait()), c.pml.pending_counts()


def cancel(c, pkg):
    """A cancelled recv completes and does not consume a later send; a
    cancelled unexpected send is never delivered."""
    r = c.irecv(source=0, tag=500, rank=1)
    r.cancel()
    s = r.wait()
    c.send(np.int32(77), dest=1, tag=500, rank=0)
    v, s2 = c.recv(source=0, tag=500, rank=1)
    with cvars(pkg, pml_eager_limit=1):
        sreq = c.isend(np.int32(5), dest=1, tag=501, rank=0)
    sreq.cancel()
    gone = st(c.iprobe(source=0, tag=501, rank=1))
    return st(s), r.is_cancelled, val(v), st(s2), st(sreq.wait()), gone, \
        c.pml.pending_counts()


def wait_any_prefers_blockable(c, pkg):
    dead = c.irecv(source=0, tag=501, rank=2)  # never matched
    fut = concurrent.futures.Future()
    timer = threading.Timer(0.05, fut.set_result, args=(11,))
    timer.start()
    live = pkg.req.from_future(fut)
    i, s = pkg.req.wait_any([dead, live])
    timer.join(5)
    dead.cancel()
    return i, st(s), live.value, dead.is_cancelled


def generalized(c, pkg):
    events = []
    q = pkg.req.GeneralizedRequest(
        query_fn=lambda s: pkg.req.Status(count=s["n"]),
        free_fn=lambda s: events.append("free"),
        cancel_fn=lambda s, done: events.append(("cancel", done)),
        extra_state={"n": 4})
    before = q.is_complete
    q.complete()
    count = q.wait().count
    q.cancel()
    q.free()
    return before, count, events


SEQUENCES = [ring_c, unexpected_queue, recv_before_send, wildcards,
             ordering, tag_selectivity, probe, matched_probe, bad_rank,
             payload_type, eager, rendezvous, pipelined, protocol_counters,
             ssend_rsend, sendrecv, waitall_testall, waitany_waitsome,
             persistent, wait_without_match, cancel,
             wait_any_prefers_blockable, generalized]


@pytest.mark.parametrize("seq", SEQUENCES, ids=lambda f: f.__name__)
def test_p2p_sequence_matches_jax(worlds, seq):
    jworld, tworld = worlds
    jc = jworld.dup(name=f"p2p_{seq.__name__}")
    tc = tworld.dup(name=f"p2p_{seq.__name__}")
    try:
        want = seq(jc, JAX)
        got = seq(tc, PORT)
        assert got == want
    finally:
        jc.free()
        tc.free()


# ---------------------------------------------------------------------------
# static schedules (p2p/spmd.py) against the JAX shard_map programs
# ---------------------------------------------------------------------------

def _jax_rank_program(world, body, x):
    from jax.sharding import PartitionSpec as P

    return jax.jit(jax.shard_map(body, mesh=world.submesh, in_specs=P("rank"),
                                 out_specs=P("rank")))(x)


@pytest.mark.parametrize("shift", [1, 3, -1])
def test_spmd_ring_shift_matches_jax(worlds, shift):
    jworld, _ = worlds
    x = np.random.default_rng(shift + 5).standard_normal(
        (N, 6)).astype(np.float32)
    want = _jax_rank_program(
        jworld, lambda b: jspmd.ring_shift(b, "rank", shift), x)
    got = tspmd.ring_shift(torch.from_numpy(x), shift)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))


def test_spmd_sendrecv_and_halo_match_jax(worlds):
    jworld, _ = worlds
    x = np.arange(N * 3, dtype=np.int32).reshape(N, 3)
    perm = [(0, 7), (2, 1), (5, 5)]  # ranks 0, 2-4, 6 receive zeros
    want = _jax_rank_program(jworld,
                             lambda b: jspmd.sendrecv(b, perm, "rank"), x)
    np.testing.assert_array_equal(
        tspmd.sendrecv(torch.from_numpy(x), perm).numpy(), np.asarray(want))
    for i in range(2):
        want = _jax_rank_program(
            jworld, lambda b, i=i: jspmd.halo_exchange(b, "rank")[i], x)
        got = tspmd.halo_exchange(torch.from_numpy(x))[i]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the port's own contract: tensors are mutable
# ---------------------------------------------------------------------------

def test_blocking_send_leaves_the_buffer_reusable(worlds):
    """A standard send returns with the caller's buffer reusable even
    when its rendezvous is still pending; an isend's buffer belongs to
    the engine until the request completes (MPI's rule)."""
    _, tworld = worlds
    c = tworld.dup(name="p2p_buffer_reuse")
    try:
        with cvars(PORT, pml_eager_limit=16):
            buf = torch.arange(64, dtype=torch.float32)
            c.send(buf, dest=1, tag=1, rank=0)
            req = c.isend(buf, dest=1, tag=2, rank=0)
            buf += 100  # the blocking send's message is already safe
            sent, _ = c.recv(source=0, tag=1, rank=1)
            assert torch.equal(sent, torch.arange(64, dtype=torch.float32))
            isent, _ = c.recv(source=0, tag=2, rank=1)
            assert req.is_complete and torch.equal(isent, buf)
        small = torch.ones(4)
        c.send(small, dest=2, tag=3, rank=0)  # eager: copied at send
        small.zero_()
        assert torch.equal(c.recv(source=0, tag=3, rank=2)[0], torch.ones(4))
    finally:
        c.free()


def test_payload_lands_on_the_comm_device_as_a_tensor(worlds):
    _, tworld = worlds
    c = tworld.dup(name="p2p_device")
    try:
        c.send(np.float32(2.5), dest=1, tag=1, rank=0)
        v, s = c.recv(source=0, tag=1, rank=1)
        assert isinstance(v, torch.Tensor) and v.device == c.device
        assert v.shape == () and s.count == 1
        assert c.pml is c.pml  # one engine per communicator
    finally:
        c.free()


def test_communicator_wraps_matched_probe_and_persistent(worlds):
    """The port's communicator carries the engine's improbe/mrecv and
    send_init/recv_init with the acting rank as ``rank=``."""
    _, tworld = worlds
    c = tworld.dup(name="p2p_comm_surface")
    try:
        c.send(np.arange(3, dtype=np.int32), dest=4, tag=8, rank=1)
        msg = c.improbe(source=-1, tag=8, rank=4)
        v, s = c.mrecv(msg, rank=4)
        assert v.tolist() == [0, 1, 2] and (s.source, s.tag) == (1, 8)
        assert c.improbe(source=-1, tag=8, rank=4) is None
        sreq = c.send_init(np.float32(6), dest=2, tag=9, rank=3)
        rreq = c.recv_init(source=3, tag=9, rank=2)
        for _ in range(2):
            rreq.start()
            sreq.start()
            assert float(rreq.value) == 6.0 and rreq.wait().source == 3
        assert c.pml.pending_counts() == (0, 0)
    finally:
        c.free()


# ---------------------------------------------------------------------------
# the ported examples
# ---------------------------------------------------------------------------

def test_ring_example_closed_form(worlds):
    """``examples/ring_tpu.py``'s ring over the first 4 of 8 ranks:
    ``(n - 1) + laps * n`` receives in the loop (the JAX test counts the
    final drain too: ``n * (laps + 1)``) and a final 0."""
    from ompi_release_tpu_torch.examples import ring_tpu

    _, tworld = worlds
    n, laps = 4, ring_tpu.LAPS
    passes, last = ring_tpu.ring(tworld)
    assert (passes, last) == ((n - 1) + laps * n, 0)
    assert passes + 1 == n * (laps + 1)
    assert tworld.pml.pending_counts() == (0, 0)


@pytest.mark.parametrize("name", [
    "hello_tpu", "ring_tpu", "allreduce_tpu", "connectivity_tpu",
    "hello_oshmem_tpu", "ring_oshmem_tpu", "oshmem_reduction_tpu",
    "unified_world_tpu"])
def test_examples_run_on_the_host(name):
    """Each example's ``main(device="cpu")`` brings the runtime up, runs
    and finalizes, in a process of its own (finalize frees every
    communicator of the process)."""
    code = (f"from ompi_release_tpu_torch.examples import {name}\n"
            f"raise SystemExit({name}.main(device='cpu'))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert {"hello_tpu": "Hello, world", "ring_tpu": "ring complete: 15",
            "allreduce_tpu": "allreduce OK: 8 ranks",
            "connectivity_tpu": "connectivity OK: 28 pairs",
            "hello_oshmem_tpu": "hello_oshmem complete",
            "ring_oshmem_tpu": "ring_oshmem complete: 32 passes over 8",
            "oshmem_reduction_tpu": "oshmem_reduction complete",
            "unified_world_tpu": "unified world OK (ranks 0..7 of 8)",
            }[name] in res.stdout
