#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the repository root on a machine with a card:
``python3 chip_smoke.py``. It builds the CUDA kernels from
``ompi_release_tpu_torch/csrc`` with ``nvcc``, then:

1. prints the card (``nvidia-smi`` name and power limit) and the build
   time;
2. holds each kernel against its plain PyTorch twin on the card: the
   streaming kernels at sizes 1, 4097, 2^26+3 and a view at element
   offset 1 (f32 and bf16); the transpose bitwise at (8192, 8192) int32,
   (4097, 1000) f32 and (1, 1); the chain hop bitwise against ``x + 1``;
3. drives the main path, each slice's part with every launch counter
   set to 0 just before and read just after:
   - slice 1: ``init()`` with 8 virtual ranks on ``cuda:0``, a tuned
     communicator, allreduce f32 SUM from 8 B to 256 MiB per rank,
     reduce_scatter_block, bcast, allgather, alltoall, the fused
     allreduce on WORLD and the axpy/scale bench loops; every result is
     checked bitwise against the same calls with ``--mca op ^cuda``
     (the plain add on the card) and against closed forms;
   - slice 2: the ported ring example (ring over the first 4 of the 8
     ranks), a 256 MiB f32 send/recv from rank 0 to rank 5 (pipelined
     protocol), sendrecv/ring_shift/halo_exchange on 8 ranks, and the
     transpose and chain loops (eager and graph-replayed); each checked
     against its closed form;
4. times the kernels (CUDA events, median of 7) at the main path's
   shapes beside their bound, their plain twins and one PyTorch library
   call (the chain hop eager and replayed from a CUDA graph), and the
   tuned allreduce per size (time and bus bandwidth 2(n-1)/n * bytes /
   t); a torch.profiler window per size says where the allreduce's
   device time goes;
5. runs the port's bench suite (``ompi_release_tpu_torch.bench``, the
   five BASELINE configs) in-process and prints its lines, the headline
   ``op_sum_256MiB_f32_hbm_bw`` last among them.

Any mismatch raises (exit code != 0) before the last line. The last
line is ``{"ok": true, "device": {...}}``. Without CUDA it exits 2 and
prints no result.
"""

import json
import statistics
import subprocess
import sys
import time

#: H100 SXM published HBM rate (bytes/s), the denominator of bound_ms
HBM_BYTES_PER_S = 3.35e12
N_RANKS = 8
MIB = 1 << 20
SOURCE = "ompi_release_tpu_torch/csrc/stream_ops.cu"
KERNELS = {
    # wrapper -> (TPU kernel it replaces, streams moved per element); all
    # three Pallas bodies launch through _blocked_call's pallas_call
    # (pallas_op.py:79)
    "sum": ("ompi_release_tpu/ops/pallas_op.py:156", 3),   # _pallas_sum_fn
    "axpy": ("ompi_release_tpu/ops/pallas_op.py:93", 3),   # axpy
    "scale": ("ompi_release_tpu/ops/pallas_op.py:105", 2),  # scale
}
#: the transpose (make_transpose_loop) and chain (make_chain_loop)
#: pallas_calls
TRANSPOSE_REPLACES = "ompi_release_tpu/ops/pallas_op.py:300"
CHAIN_REPLACES = "ompi_release_tpu/ops/pallas_op.py:336"
TRANSPOSE_N = 8192  # alltoall_i32_torus's (n, n) int32
P2P_BYTES = 256 * MIB
HOPS_TIMED = 1000  # dependent chain hops per timing window


def log(msg):
    print(msg, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 \
        else f"nvidia-smi failed: {res.stderr.strip()}"


def bits_equal(a, b):
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}.get(
        a.element_size())
    return bool(torch.equal(a.view(view), b.view(view))) if view else \
        bool(torch.equal(a, b))


def ulp_close(got, want, dtype):
    """f32: rtol 1e-6; bf16: within one bf16 ulp of the plain twin."""
    import torch

    got, want = got.float(), want.float()
    if dtype is torch.float32:
        return bool(torch.allclose(got, want, rtol=1e-6, atol=0))
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    return bool(((got - want).abs() <= ulp).all())


def time_ms(fn, reps=7, inner=1, warmup=2):
    """Median ms per call of ``fn`` over ``reps`` CUDA-event windows of
    ``inner`` calls each, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(inner):
            fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / inner)
    return statistics.median(times)


def phase_kernels(cuda_op, torch, dev):
    """Each kernel against its plain twin at the contract's sizes."""
    for dtype in (torch.float32, torch.bfloat16):
        for n, off in ((1, 0), (4097, 0), ((1 << 26) + 3, 0), (4097, 1)):
            g = torch.Generator(device=dev).manual_seed(n + off)
            base = torch.randn(2, n + off, generator=g, device=dev).to(dtype)
            a, b = base[0, off:], base[1, off:]
            what = f"{dtype} n={n} offset={off}"
            check(bits_equal(cuda_op.sum_(a, b), cuda_op._plain_sum(a, b)),
                  f"sum kernel != plain add ({what})")
            check(ulp_close(cuda_op.axpy(a, b, 0.999),
                            cuda_op._plain_axpy(a, b, 0.999), dtype),
                  f"axpy kernel != plain ({what})")
            check(ulp_close(cuda_op.scale(a, 1.0001),
                            cuda_op._plain_scale(a, 1.0001), dtype),
                  f"scale kernel != plain ({what})")
            del base, a, b
    for shape, dtype in (((TRANSPOSE_N, TRANSPOSE_N), torch.int32),
                         ((4097, 1000), torch.float32), ((1, 1), torch.float32)):
        g = torch.Generator(device=dev).manual_seed(shape[0])
        x = torch.randint(-2**31, 2**31 - 1, shape, generator=g, device=dev,
                          dtype=torch.int32).view(dtype)  # every bit pattern
        check(bits_equal(cuda_op.transpose(x), cuda_op._plain_transpose(x)),
              f"transpose kernel != x.t().contiguous() ({shape} {dtype})")
        del x
    x = torch.randn(cuda_op.CHAIN_TILE, device=dev)
    check(bits_equal(cuda_op.chain_hop(x), cuda_op._plain_chain_hop(x)),
          "chain hop kernel != x + 1")
    torch.cuda.synchronize()
    log("phase 2: kernels match their plain twins (f32/bf16; n=1, 4097, "
        "2^26+3, offset 1; transpose (8192, 8192) int32, (4097, 1000) f32, "
        "(1, 1) bitwise; chain hop bitwise)")


def drive_main_path(mpi, tmvar, torch, dev):
    """The user path: returns every input and output for the checks."""
    world = mpi.init(cli_args=["--mca", "runtime_virtual_ranks",
                               str(N_RANKS)])
    check(world.size == N_RANKS and world.device == dev,
          f"WORLD is {world.size} ranks on {world.device}")
    tmvar.set_value("coll", "tuned")
    try:
        tuned = world.dup(name="tuned")
    finally:
        tmvar.VARS.unset("coll")
    g = torch.Generator(device=dev).manual_seed(1234)
    runs = []  # (comm, method, input, kwargs, output)

    def run(comm, method, x, **kw):
        runs.append((comm, method, x, kw, getattr(comm, method)(x, **kw)))

    for nbytes in (8, 4 << 10, 64 << 10, 4 * MIB, 16 * MIB, 256 * MIB):
        count = nbytes // 4
        run(tuned, "allreduce",
            torch.randn(N_RANKS, count, generator=g, device=dev))
        run(tuned, "allreduce", torch.ones(N_RANKS, count, device=dev))
    ints = lambda shape: torch.randint(  # noqa: E731  exact in any order
        -64, 64, shape, generator=g, device=dev).float()
    run(tuned, "reduce_scatter_block", ints((N_RANKS, 32 * MIB)))
    run(tuned, "bcast", torch.randn(N_RANKS, 64 * MIB, generator=g,
                                    device=dev), root=3)
    run(tuned, "allgather", torch.randn(
        N_RANKS, 16 * MIB, generator=g, device=dev).to(torch.bfloat16))
    run(tuned, "alltoall", torch.randint(
        -2**31, 2**31 - 1, (N_RANKS, 8 * MIB), generator=g, device=dev,
        dtype=torch.int32))
    run(world, "allreduce", ints((N_RANKS, 16 * MIB)))
    tuned.barrier()
    world.barrier()
    return world, tuned, runs


def drive_bench_loops(cuda_op, torch, dev):
    rows = cols = 8192  # 2^26 elements: 256 MiB f32
    a = torch.rand(rows, cols, device=dev)
    axpy_sum = cuda_op.make_axpy_loop(rows, cols)(a, 4)
    scale_sum = cuda_op.make_scale_loop(rows, cols)(a, 4)
    torch.cuda.synchronize()
    return a, float(axpy_sum), float(scale_sum)


def drive_p2p_path(world, cuda_op, torch, dev):
    """Slice 2's path on the WORLD of 8 virtual ranks: the ring example,
    a pipelined 256 MiB send, the static p2p schedules and the
    transpose/chain loops. Returns what the checks need."""
    from ompi_release_tpu_torch.examples import ring_tpu
    from ompi_release_tpu_torch.mca import pvar as tpvar
    from ompi_release_tpu_torch.p2p import spmd as p2p_spmd

    out = {"ring": ring_tpu.ring(world)}
    g = torch.Generator(device=dev).manual_seed(5)
    pipelined = tpvar.PVARS.lookup("pml_pipelined_sends")
    before = pipelined.read()
    payload = torch.randn(P2P_BYTES // 4, generator=g, device=dev)
    world.send(payload, dest=5, tag=42, rank=0)
    got, st = world.recv(source=0, tag=42, rank=5)
    out["send"] = (payload, got, st, pipelined.read() - before)
    x = torch.randn(N_RANKS, 4096, generator=g, device=dev)
    out["static"] = (x, p2p_spmd.ring_shift(x, 3),
                     p2p_spmd.sendrecv(x, [(0, 7), (2, 1)]),
                     p2p_spmd.halo_exchange(x))
    out["sendrecv"] = world.sendrecv(
        [x[r] for r in range(N_RANKS)],
        [(r + 1) % N_RANKS for r in range(N_RANKS)], sendtag=9,
        sources=[(r - 1) % N_RANKS for r in range(N_RANKS)], recvtag=9)
    n = TRANSPOSE_N
    a = torch.randint(-2**20, 2**20, (n, n), generator=g, device=dev,
                      dtype=torch.int32)
    t_loop, _ = cuda_op.make_transpose_loop(n)
    af = a[:8, :128].float().contiguous()
    k_graph = 2 * cuda_op.GRAPH_BLOCK + 3
    out["loops"] = (a, int(t_loop(a, 2)), af,
                    float(cuda_op.make_chain_loop(4)(af, 25)),
                    float(cuda_op.make_chain_loop(4, graph=True)(af, k_graph)),
                    k_graph)
    torch.cuda.synchronize()
    return out


def check_p2p_path(torch, out):
    passes, last = out["ring"]
    n, laps = 4, 3  # ring_tpu: the first 4 ranks, LAPS laps
    check((passes, last) == ((n - 1) + laps * n, 0),
          f"ring example: {passes} passes, final {last}")
    payload, got, st, pipelined = out["send"]
    check(bits_equal(got, payload), "256 MiB send/recv != payload")
    check((st.source, st.tag, st.count) == (0, 42, payload.numel()),
          f"256 MiB recv status {st}")
    check(pipelined == 1, f"256 MiB send took {pipelined} pipelined moves")
    x, shifted, sparse, (from_left, from_right) = out["static"]
    idx = lambda rows: torch.tensor(rows, device=x.device)  # noqa: E731
    check(bits_equal(shifted, x[idx([(r - 3) % N_RANKS
                                     for r in range(N_RANKS)])]),
          "ring_shift != x[(r - 3) % n]")
    want = torch.zeros_like(x)
    want[7], want[1] = x[0], x[2]
    check(bits_equal(sparse, want), "sendrecv schedule != its closed form")
    want_l, want_r = torch.zeros_like(x), torch.zeros_like(x)
    want_l[1:], want_r[:-1] = x[:-1], x[1:]
    check(bits_equal(from_left, want_l) and bits_equal(from_right, want_r),
          "halo_exchange != shifted rows with zero boundaries")
    values, statuses = out["sendrecv"]
    for r in range(N_RANKS):
        check(bits_equal(values[r], x[(r - 1) % N_RANKS])
              and statuses[r].source == (r - 1) % N_RANKS,
              f"PML sendrecv at rank {r}")
    a, t_sum, af, eager_sum, graph_sum, k_graph = out["loops"]
    check(t_sum == int(a[0, 0]) + int(a[-1, -1]),
          "transpose loop checksum != a[0, 0] + a[-1, -1]")
    base = float(af[0, 0]) + float(af[-1, -1])
    check(eager_sum == base + 2 * 4 * 25, "eager chain loop checksum")
    check(graph_sum == base + 2 * 4 * k_graph, "graph chain loop checksum")
    log("phase 3: ring example (15 passes, final 0), pipelined 256 MiB "
        "send, static schedules, PML sendrecv and the transpose/chain "
        "loop checksums match their closed forms")


def check_main_path(tmvar, torch, runs, bench):
    n = N_RANKS
    for comm, method, x, kw, out in runs:
        what = f"{comm.name}.{method} {tuple(x.shape)} {x.dtype}"
        check(bool(torch.isfinite(out.float()).all()) if out.is_floating_point()
              else True, f"{what}: non-finite output")
        if method == "allreduce":
            check(out.shape == x.shape, f"{what}: shape {tuple(out.shape)}")
            if bool((x == 1).all()):
                check(bool((out == n).all()), f"{what}: all-ones != {n}")
            if comm.name == "MPI_COMM_WORLD":  # integer-valued: exact
                check(bits_equal(out, x.sum(0, keepdim=True).expand_as(x)
                                 .contiguous()), f"{what}: != exact sum")
        elif method == "reduce_scatter_block":
            want = x.view(n, n, -1).sum(0)  # integer-valued: exact
            check(bits_equal(out, want), f"{what}: != exact block sums")
        elif method == "bcast":
            check(bits_equal(out, x[kw["root"]].expand_as(x).contiguous()),
                  f"{what}: != root's buffer")
        elif method == "allgather":
            check(bits_equal(out, x.reshape(1, -1).expand(n, -1).contiguous()),
                  f"{what}: != concatenation")
        elif method == "alltoall":
            check(bits_equal(out, x.view(n, n, -1).transpose(0, 1)
                             .reshape(x.shape)), f"{what}: != transpose")
        if method in ("allreduce", "reduce_scatter_block"):
            # the same call with the CUDA op component excluded: the plain
            # add on the card, in the same algorithm order -> same bits
            tmvar.set_value("op", "^cuda")
            try:
                plain = getattr(comm, method)(x, **kw)
            finally:
                tmvar.VARS.unset("op")
            check(bits_equal(out, plain), f"{what}: != op ^cuda result")
    a, axpy_sum, scale_sum = bench
    acc = torch.zeros_like(a)
    for _ in range(4):
        acc = acc * 0.999 + a
    want = float(acc[0, 0] + acc[-1, -1])
    check(abs(axpy_sum - want) <= 1e-5 * abs(want), "axpy loop checksum")
    acc = a
    for _ in range(4):
        acc = acc * 1.0001
    want = float(acc[0, 0] + acc[-1, -1])
    check(abs(scale_sum - want) <= 1e-5 * abs(want), "scale loop checksum")
    torch.cuda.synchronize()
    log(f"phase 3: {len(runs)} collective results match the op ^cuda runs "
        "bitwise and their closed forms; bench loop checksums match")


def time_kernels(cuda_op, torch, dev, launches):
    """Each kernel at the main path's largest per-call shape (the
    segmented-ring combine at 256 MiB per rank: 2^26 f32 elements)."""
    numel = 1 << 26
    g = torch.Generator(device=dev).manual_seed(99)
    a = torch.randn(numel, generator=g, device=dev)
    b = torch.randn(numel, generator=g, device=dev)
    cases = {
        "sum": (lambda: cuda_op.sum_(a, b), lambda: cuda_op._plain_sum(a, b),
                lambda: torch.add(b, a)),
        "axpy": (lambda: cuda_op.axpy(a, b, 0.999),
                 lambda: cuda_op._plain_axpy(a, b, 0.999),
                 lambda: torch.add(a, b, alpha=0.999)),
        "scale": (lambda: cuda_op.scale(a, 1.0001),
                  lambda: cuda_op._plain_scale(a, 1.0001),
                  lambda: torch.mul(a, 1.0001)),
    }
    rows = []
    for name, (kern, plain, lib) in cases.items():
        replaces, streams = KERNELS[name]
        err = float((kern().float() - plain().float()).abs().max())
        rows.append({
            "name": f"stream_{'scale' if name == 'scale' else 'axpy'}"
                    f"[{name}]",
            "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err,
            "ms": time_ms(kern, inner=10), "plain_ms": time_ms(plain, inner=10),
            "bound_ms": streams * numel * 4 / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": time_ms(lib, inner=10),
            "shape": [numel], "dtype": "float32",
        })
    rows.append(time_transpose(cuda_op, torch, dev, launches["transpose"]))
    rows.append(time_chain(cuda_op, torch, dev, launches["chain"]))
    return rows


def time_transpose(cuda_op, torch, dev, launches):
    """The transpose at alltoall_i32_torus's (8192, 8192) int32."""
    n = TRANSPOSE_N
    x = torch.randint(-2**31, 2**31 - 1, (n, n), device=dev,
                      dtype=torch.int32)
    err = float((cuda_op.transpose(x).double()
                 - cuda_op._plain_transpose(x).double()).abs().max())
    return {
        "name": "tile_transpose_32", "route": "cuda", "source": SOURCE,
        "replaces": TRANSPOSE_REPLACES, "launches": launches,
        "max_abs_err": err,
        "ms": time_ms(lambda: cuda_op.transpose(x), inner=10),
        "plain_ms": time_ms(lambda: cuda_op._plain_transpose(x), inner=10),
        "bound_ms": 2 * n * n * 4 / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": time_ms(lambda: x.t().contiguous(), inner=10),
        "shape": [n, n], "dtype": "int32",
    }


def hop_ms(torch, hop, x, graph):
    """ms per hop over HOPS_TIMED dependent hops, launched from Python
    (eager) or replayed from one CUDA graph holding all of them."""
    def chain():
        y = x
        for _ in range(HOPS_TIMED):
            y = hop(y)
        return y

    if not graph:
        return time_ms(chain) / HOPS_TIMED
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        chain()
    return time_ms(g.replay) / HOPS_TIMED


def time_chain(cuda_op, torch, dev, launches):
    """The chain hop on its (8, 128) f32 tile, eager and in a graph,
    beside torch.add(x, 1) timed the same two ways."""
    x = torch.randn(cuda_op.CHAIN_TILE, device=dev)
    err = float((cuda_op.chain_hop(x) - cuda_op._plain_chain_hop(x))
                .abs().max())
    lib = lambda y: torch.add(y, 1)  # noqa: E731
    return {
        "name": "chain_add_one", "route": "cuda", "source": SOURCE,
        "replaces": CHAIN_REPLACES, "launches": launches,
        "max_abs_err": err,
        "ms": hop_ms(torch, cuda_op.chain_hop, x, graph=False),
        "ms_graph": hop_ms(torch, cuda_op.chain_hop, x, graph=True),
        "plain_ms": hop_ms(torch, cuda_op._plain_chain_hop, x, graph=False),
        "bound_ms": 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": hop_ms(torch, lib, x, graph=False),
        "library_ms_graph": hop_ms(torch, lib, x, graph=True),
        "shape": list(cuda_op.CHAIN_TILE), "dtype": "float32",
        "per": "hop",
    }


def run_bench(torch, dev):
    """Phase 5: the port's bench suite in-process, headline last."""
    from ompi_release_tpu_torch import bench as tbench

    t0 = time.perf_counter()
    lines, headline = tbench.run_suite(dev)
    for ln in lines + [headline]:
        check(ln["device"] == torch.cuda.get_device_name(dev),
              f"bench line without the card's name: {ln}")
        log(json.dumps(ln))
    check(headline["metric"] == "op_sum_256MiB_f32_hbm_bw",
          f"bench headline {headline['metric']}")
    log(f"phase 5: bench suite took {time.perf_counter() - t0:.1f} s")


def time_allreduce(tuned, torch, dev):
    g = torch.Generator(device=dev).manual_seed(7)
    for nbytes in (8, 4 << 10, 64 << 10, 4 * MIB, 16 * MIB, 256 * MIB):
        x = torch.randn(N_RANKS, nbytes // 4, generator=g, device=dev)
        ms = time_ms(lambda: tuned.allreduce(x), reps=5)
        busbw = 2 * (N_RANKS - 1) / N_RANKS * nbytes / (ms * 1e-3) / 1e9
        log(json.dumps({"tuned_allreduce_bytes_per_rank": nbytes,
                        "ms": ms, "bus_GBps": busbw}))
        del x


def profile_allreduce(tuned, torch, dev):
    """Where the tuned allreduce's time goes: one torch.profiler window
    of 3 calls per size; prints the window's host time, the summed device
    kernel time (busy share = busy / window) and the top kernels. A
    profiler failure is reported, not fatal: the numbers are diagnostic."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(11)
    for nbytes in (4 * MIB, 256 * MIB):
        x = torch.randn(N_RANKS, nbytes // 4, generator=g, device=dev)
        tuned.allreduce(x)
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(3):
                    tuned.allreduce(x)
                torch.cuda.synchronize()
                window_ms = (time.perf_counter() - t0) * 1e3
            kernels = [e for e in prof.key_averages()
                       if str(getattr(e, "device_type", "")).endswith("CUDA")]
            dev_us = lambda e: getattr(  # noqa: E731
                e, "self_device_time_total",
                getattr(e, "self_cuda_time_total", 0))
            busy_ms = sum(dev_us(e) for e in kernels) / 1e3
            top = sorted(kernels, key=dev_us, reverse=True)[:6]
            log(json.dumps({
                "profile_tuned_allreduce_bytes_per_rank": nbytes,
                "calls": 3, "window_ms": window_ms,
                "device_busy_ms": busy_ms,
                "busy_share": busy_ms / window_ms,
                "launches": sum(e.count for e in kernels),
                "top": [[e.key[:80], dev_us(e) / 1e3, e.count]
                        for e in top]}))
        except Exception as exc:  # diagnostic only: report and go on
            log(f"profile at {nbytes} B per rank failed: {exc!r}")
        del x


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import ompi_release_tpu_torch as mpi
    from ompi_release_tpu_torch.mca import var as tmvar
    from ompi_release_tpu_torch.ops import cuda_op

    dev = torch.device("cuda", 0)
    log(f"card: {card_line()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    so = cuda_op.build()
    log(f"phase 1: built {so} in {time.perf_counter() - t0:.2f} s")

    phase_kernels(cuda_op, torch, dev)

    cuda_op.reset_launches()
    world, tuned, runs = drive_main_path(mpi, tmvar, torch, dev)
    bench = drive_bench_loops(cuda_op, torch, dev)
    torch.cuda.synchronize()
    launches = {name: cuda_op.LAUNCHES[name] for name in KERNELS}
    log(f"phase 3: main-path launches {launches}")
    for name, count in launches.items():
        check(count > 0, f"kernel wrapper {name} launched no time on the "
                         "main path")
    check_main_path(tmvar, torch, runs, bench)
    del runs, bench
    torch.cuda.empty_cache()

    cuda_op.reset_launches()
    p2p = drive_p2p_path(world, cuda_op, torch, dev)
    torch.cuda.synchronize()
    launches_p2p = dict(cuda_op.LAUNCHES)
    log(f"phase 3: slice-2 path launches {launches_p2p}")
    for name in ("transpose", "chain"):
        check(launches_p2p[name] > 0, f"kernel wrapper {name} launched no "
                                      "time on the main path")
        launches[name] = launches_p2p[name]
    check_p2p_path(torch, p2p)
    del p2p
    torch.cuda.empty_cache()

    rows = time_kernels(cuda_op, torch, dev, launches)
    time_allreduce(tuned, torch, dev)
    profile_allreduce(tuned, torch, dev)
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        " GiB")
    tuned.free()
    mpi.finalize()
    torch.cuda.empty_cache()
    run_bench(torch, dev)
    log(card_line())
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
