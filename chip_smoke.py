#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the repository root on a machine with a card:
``python3 chip_smoke.py``. It builds the CUDA kernels from
``ompi_release_tpu_torch/csrc`` with ``nvcc``, then:

1. prints the card (``nvidia-smi`` name and power limit), the build
   time and each kernel's registers, shared memory and spills (ptxas
   ``-v``, kept by the build), and each flash kernel's tensor-core
   (``HGMMA``) and atomic instructions from ``cuobjdump -sass``: the two
   bf16 backward kernels must hold HGMMA and no atomic;
2. holds each kernel against its plain PyTorch twin on the card: the
   streaming kernels at sizes 1, 4097, 2^26+3 and a view at element
   offset 1 (f32 and bf16); the transpose bitwise at (8192, 8192) int32,
   (4097, 1000) f32 and (1, 1); the chain hop bitwise against ``x + 1``;
   the flash-attention forward causal and not, S in {1, 100, 129, 2048},
   D in {8, 64, 128}, f32 and bf16, and at the model's (64, 2048, 64)
   bf16 causal (out f32 rtol/atol 2e-5, bf16 within one bf16 ulp plus
   2e-5, lse atol 1e-5: both compute in f32 in another summation order);
   the flash-attention backward kernels (dq, and dk/dv) each against its
   own plain twin, causal and not, S in {1, 100, 129, 256}, D in {8, 64,
   128}, f32 and bf16, the whole backward at the model's shape, run
   twice and bitwise equal, and at the model's width in 128-wide heads,
   (32, 2048, 128) bf16 causal (f32 rtol/atol 2e-4, the JAX suite's grad
   tolerance; bf16 within one bf16 ulp plus 2e-4: each gradient is an
   f32 sum of up to S products in another order on each side); then
   logs, ungated, whether cuBLAS reduces the trunk's bf16 products in
   bf16 (``column_parallel`` with
   ``allow_bf16_reduced_precision_reduction`` on and off against the f32
   product rounded once);
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
   - slice 3: the flagship TpuLM's eval forward at full width
     (``ModelConfig()``: vocab 32000, d_model 512, 8 layers, 8 x 64
     heads, d_ff 2048, bf16, random weights from seed 0) over 3 batches
     of (8, 2048) tokens with ``attn_impl="auto"``: the flash kernel
     must launch 8 layers x 3 batches = 24 times, each loss must be
     finite and within 1.0 of ln(32000), and the first batch must give
     the same loss through ring attention (bf16 rel 1e-2; in f32 rel
     1e-4, f32 products in full f32: TF32 off);
   - slice 4: the TpuLM train step at full width (a fresh
     ``TpuLM(ModelConfig())`` from seed 0, ``adamw(1e-3)``) for 4 steps
     on one fixed (8, 2048) batch: ``flash_fwd``, ``flash_bwd_dq`` and
     ``flash_bwd_dkv`` must each launch 8 layers x 4 steps = 32 times,
     every loss must be finite and the last below the first; then, from
     the state those steps left, one step's loss and gradients through
     the kernels (``"flash"``) against plain autograd through ring
     attention (``"ring"``): loss rel 1e-2, every parameter's gradient
     within a relative L2 error of 3e-2 (bf16);
4. times the kernels (CUDA events, median of 7) at the main path's
   shapes beside their bound, their plain twins and one PyTorch library
   call (the chain hop eager and replayed from a CUDA graph; the flash
   forward beside ``scaled_dot_product_attention``, the two backward
   kernels beside SDPA's backward, timed only), and the tuned allreduce
   per size (time and bus bandwidth 2(n-1)/n * bytes / t); a
   torch.profiler window per size says where the allreduce's device time
   goes, one over an eval batch where the forward's goes and one over a
   train step where the step's goes (busy share, top kernels, host
   gaps); the forward's ms per batch and the train step's ms per step,
   tokens/s and peak memory;
5. runs the port's bench suite (``ompi_release_tpu_torch.bench``, the
   five BASELINE configs) in-process and prints its lines, the headline
   ``op_sum_256MiB_f32_hbm_bw`` last among them.

Any mismatch or failure raises (exit code != 0) before the last line;
no phase's failure is caught. The last
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
#: H100 SXM published dense peaks (flop/s): bf16 tensor cores, and f32
#: on the CUDA cores (the flash kernel's floor; it uses no tensor cores)
BF16_FLOPS = 989e12
F32_CUDA_CORE_FLOPS = 67e12
N_RANKS = 8
MIB = 1 << 20
SOURCE = "ompi_release_tpu_torch/csrc/stream_ops.cu"
FLASH_SOURCE = "ompi_release_tpu_torch/csrc/flash_attn.cu"
#: the forward pallas_call of _flash_forward (body _attn_kernel :38)
FLASH_REPLACES = "ompi_release_tpu/ops/pallas_attention.py:114"
#: the main path's flash call: (B * H, S, D) bf16 causal
FLASH_SHAPE = (64, 2048, 64)
FLASH_BWD_SOURCE = "ompi_release_tpu_torch/csrc/flash_attn_bwd.cu"
#: the bf16 route of the two backward entries, on the tensor cores (wgmma)
FLASH_BWD_BF16_SOURCE = "ompi_release_tpu_torch/csrc/flash_attn_bwd_wgmma.cu"
#: the model's attention at head dim 128 (d_model 512 as 4 x 128 heads)
FLASH_SHAPE_D128 = (32, 2048, 128)
#: the trunk's bf16 products, (8 x 2048, d_model) x (d_model, F) and the
#: FFN's way back (ROADMAP queue 3 item 1)
TRUNK_PRODUCTS = (((16384, 512), (512, 512)), ((16384, 512), (512, 2048)),
                  ((16384, 2048), (2048, 512)))
#: the two backward pallas_calls of _flash_backward (bodies
#: _bwd_dq_kernel :140 and _bwd_dkv_kernel :185)
DQ_REPLACES = "ompi_release_tpu/ops/pallas_attention.py:264"
DKV_REPLACES = "ompi_release_tpu/ops/pallas_attention.py:283"
TRAIN_STEPS = 4  # slice 4's window: train steps on one fixed batch
SDPA_BWD_CALLS = 5  # SDPA backward calls in its profiler window
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


def bf16_ulp(x):
    """One bf16 ulp at each value of the f32 tensor ``x``."""
    import torch

    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def ulp_close(got, want, dtype, atol=0.0):
    """f32: rtol 1e-6; bf16: within one bf16 ulp of the plain twin (plus
    ``atol``)."""
    import torch

    got, want = got.float(), want.float()
    if dtype is torch.float32:
        return bool(torch.allclose(got, want, rtol=1e-6, atol=0))
    return bool(((got - want).abs() <= bf16_ulp(want) + atol).all())


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


def ptxas_report(cuda_op, lib):
    """Phase 1: each kernel's registers, static shared memory and spills
    from the build's ptxas ``-v`` report, and the flash kernel's dynamic
    shared memory (ptxas cannot see it)."""
    import re

    with open(cuda_op.ptxas_log_path(lib)) as fh:
        text = fh.read()
    kernel, spill = None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = [int(m.group(1)), int(m.group(2))]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            smem = re.search(r"(\d+) bytes smem", line)
            log(json.dumps({"ptxas_kernel": kernel,
                            "registers": int(m.group(1)),
                            "static_smem_bytes": int(smem.group(1))
                            if smem else 0,
                            "spill_stores_loads_bytes": spill}))
            kernel, spill = None, None
    load = cuda_op._load()
    log(json.dumps({"flash_dynamic_smem_bytes": {
        name: {d: int(getattr(load, f"{name}_smem_bytes")(d))
               for d in (8, 64, 128)}
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                     "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16")}}))


def sass_report(cuda_op, lib):
    """Phase 1: per flash kernel of the built library, its count of
    tensor-core (``HGMMA``) and atomic (``ATOM*``, ``RED``) instructions
    from ``cuobjdump -sass``. Each instantiation of the two bf16 backward
    kernels must hold HGMMA and no atomic. Returns {wrapper: {padded head
    dim: HGMMA count}} for those two."""
    import os
    import re

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    res = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=300)
    check(res.returncode == 0, f"cuobjdump -sass failed: {res.stderr}")
    counts, fn = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {"HGMMA": 0, "atomic": 0}
        elif fn:
            counts[fn]["HGMMA"] += bool(re.search(r"\bHGMMA\b", line))
            counts[fn]["atomic"] += bool(re.search(r"\b(ATOM\w*|RED)\b",
                                                   line))
    hgmma = {}
    for name, wrapper in (("flash_bwd_dq_wgmma", "flash_bwd_dq"),
                          ("flash_bwd_dkv_wgmma", "flash_bwd_dkv")):
        for dp in (64, 128):
            found = [c for f, c in counts.items()
                     if f"{name}ILi{dp}E" in f]
            check(len(found) == 1, f"{name}<{dp}> not in the library's SASS")
            check(found[0]["HGMMA"] > 0, f"{name}<{dp}> has no HGMMA")
            check(found[0]["atomic"] == 0, f"{name}<{dp}> has atomics")
            hgmma.setdefault(wrapper, {})[dp] = found[0]["HGMMA"]
    log(json.dumps({"sass_flash_kernels": {
        f: c for f, c in counts.items() if "flash" in f}}))
    log(f"phase 1: HGMMA per bf16 backward kernel {hgmma}; no atomics")
    return hgmma


def check_bf16_reduction(torch, dev):
    """ROADMAP queue 3 item 1: does cuBLAS reduce bf16 products in bf16?
    ``column_parallel`` at the trunk's shapes with
    ``allow_bf16_reduced_precision_reduction`` on and off, each against
    the f32 product rounded once to bf16; logged, not gated."""
    from ompi_release_tpu_torch.parallel.tp import column_parallel

    flags = torch.backends.cuda.matmul
    saved = flags.allow_bf16_reduced_precision_reduction
    g = torch.Generator(device=dev).manual_seed(12)
    out = []
    try:
        for xs, ws in TRUNK_PRODUCTS:
            x = torch.randn(*xs, generator=g, device=dev).to(torch.bfloat16)
            w = (torch.randn(*ws, generator=g, device=dev)
                 * xs[1] ** -0.5).to(torch.bfloat16)
            want = (x.float() @ w.float()).to(torch.bfloat16).float()
            row = {"x": list(xs), "w": list(ws)}
            got = {}
            for on in (True, False):
                flags.allow_bf16_reduced_precision_reduction = on
                got[on] = column_parallel(x, w).float()
                diff = (got[on] - want).abs()
                beyond = diff > bf16_ulp(want)
                row["on" if on else "off"] = {
                    "max_abs_diff": float(diff.max()),
                    "elements_differing": int((diff > 0).sum()),
                    "beyond_one_ulp": int(beyond.sum()),
                    "max_abs_value_there": float(want.abs()[beyond].max())
                    if bool(beyond.any()) else None}
            row["on_equals_off"] = bool(torch.equal(got[True], got[False]))
            out.append(row)
    finally:
        flags.allow_bf16_reduced_precision_reduction = saved
    log(json.dumps({"bf16_reduced_precision_reduction": out,
                    "default": saved}))


def flash_close(torch, got, want, got_lse, want_lse):
    """out: f32 rtol/atol 2e-5; bf16 within one bf16 ulp plus the f32
    atol 2e-5 (each side rounds its own f32 result once, and near zero
    the two f32 sums differ by more than a bf16 ulp of the value);
    lse atol 1e-5."""
    ok = bool(torch.allclose(got, want, rtol=2e-5, atol=2e-5)) \
        if got.dtype is torch.float32 else \
        ulp_close(got, want, got.dtype, atol=2e-5)
    return ok and bool(torch.allclose(got_lse, want_lse, rtol=0, atol=1e-5))


def phase_flash(fa, torch, dev):
    """The flash forward against its plain twin at the contract's cases
    and at the model's shape."""
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            for s in (1, 100, 129, 2048):
                for d in (8, 64, 128):
                    g = torch.Generator(device=dev).manual_seed(s * 1000 + d)
                    q, k, v = (torch.randn(3, s, d, generator=g, device=dev)
                               .to(dtype) for _ in range(3))
                    out, lse = fa.flash_forward(q, k, v, causal)
                    want, want_lse = fa._plain_flash_forward(q, k, v, causal)
                    check(flash_close(torch, out, want, lse, want_lse),
                          f"flash_fwd != plain twin ({dtype} causal={causal}"
                          f" S={s} D={d})")
                    n_cases += 1
    g = torch.Generator(device=dev).manual_seed(64)
    q, k, v = (torch.randn(*FLASH_SHAPE, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    out, lse = fa.flash_forward(q, k, v, True)
    want, want_lse = fa._plain_flash_forward(q, k, v, True)
    check(flash_close(torch, out, want, lse, want_lse),
          f"flash_fwd != plain twin at the model's {FLASH_SHAPE} bf16 causal")
    diff = (out.float() - want.float()).abs()
    beyond = diff > bf16_ulp(want.float())
    log(json.dumps({"flash_bf16_model_shape": {
        "max_abs_err": float(diff.max()),
        "beyond_one_ulp": int(beyond.sum()),
        "max_abs_value_there": float(want.float().abs()[beyond].max())
        if bool(beyond.any()) else None,
        "lse_max_abs_err": float((lse - want_lse).abs().max())}}))
    torch.cuda.synchronize()
    log(f"phase 2: flash_fwd matches its plain twin on {n_cases} cases "
        f"(causal and not; S 1, 100, 129, 2048; D 8, 64, 128; f32, bf16) "
        f"and at {FLASH_SHAPE} bf16 causal")


def grads_close(torch, got, want):
    """f32 rtol/atol 2e-4; bf16 within one bf16 ulp plus 2e-4."""
    for a, b in zip(got, want):
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.dtype is torch.float32:
            ok = bool(torch.allclose(a, b, rtol=2e-4, atol=2e-4))
        else:
            ok = ulp_close(a, b, a.dtype, atol=2e-4)
        if not ok:
            return False
    return True


def bwd_pair(fa, q, k, v, do, causal):
    """(kernels, plain twins) of the backward at q, k, v with cotangent
    do: each kernel against its own twin, on the same lse and delta."""
    out, lse = fa.flash_forward(q, k, v, causal)
    args = (q, k, v, lse, do, fa._delta(out, do), causal)
    return ((fa._bwd_dq_kernel(*args), *fa._bwd_dkv_kernel(*args)),
            (fa._plain_bwd_dq(*args), *fa._plain_bwd_dkv(*args)))


def phase_flash_bwd(fa, torch, dev):
    """The two backward kernels against their plain twins at the
    contract's cases, and the whole backward at the model's shape, run
    twice: bitwise equal."""
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            for s in (1, 100, 129, 256):
                for d in (8, 64, 128):
                    g = torch.Generator(device=dev).manual_seed(s * 1000 + d)
                    q, k, v, do = (torch.randn(3, s, d, generator=g,
                                               device=dev).to(dtype)
                                   for _ in range(4))
                    got, want = bwd_pair(fa, q, k, v, do, causal)
                    check(grads_close(torch, got, want),
                          f"flash backward kernels != plain twins ({dtype} "
                          f"causal={causal} S={s} D={d})")
                    n_cases += 1
    g = torch.Generator(device=dev).manual_seed(65)
    q, k, v, do = (torch.randn(*FLASH_SHAPE, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    got, want = bwd_pair(fa, q, k, v, do, True)
    check(grads_close(torch, got, want), "flash backward kernels != plain "
          f"twins at the model's {FLASH_SHAPE} bf16 causal")
    out, lse = fa.flash_forward(q, k, v, True)
    first = fa.flash_backward(q, k, v, out, lse, do, True)
    again = fa.flash_backward(q, k, v, out, lse, do, True)
    check(all(bits_equal(a, b) for a, b in zip(first, again)),
          "two runs of the flash backward differ")
    check(all(bits_equal(a, b) for a, b in zip(first, got)),
          "flash_backward != its two kernels")
    stats = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        diff = (a.float() - b.float()).abs()
        beyond = diff > bf16_ulp(b.float())
        stats[name] = {
            "max_abs_err": float(diff.max()),
            "max_abs_value": float(b.float().abs().max()),
            "beyond_one_ulp": int(beyond.sum()),
            "max_abs_value_there": float(b.float().abs()[beyond].max())
            if bool(beyond.any()) else None}
    log(json.dumps({"flash_bwd_bf16_model_shape": stats}))
    g = torch.Generator(device=dev).manual_seed(66)
    q, k, v, do = (torch.randn(*FLASH_SHAPE_D128, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    got, want = bwd_pair(fa, q, k, v, do, True)
    check(grads_close(torch, got, want), "flash backward kernels != plain "
          f"twins at {FLASH_SHAPE_D128} bf16 causal")
    log(json.dumps({"flash_bwd_bf16_d128": {
        name: float((a.float() - b.float()).abs().max())
        for name, a, b in zip(("dq", "dk", "dv"), got, want)}}))
    torch.cuda.synchronize()
    log(f"phase 2: flash_bwd_dq and flash_bwd_dkv match their plain twins "
        f"on {n_cases} cases (causal and not; S 1, 100, 129, 256; D 8, 64, "
        f"128; f32, bf16) and at {FLASH_SHAPE} and {FLASH_SHAPE_D128} bf16 "
        "causal; two runs of the backward are bitwise equal")


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


def drive_model_path():
    """Slice 3's path: the full-width TpuLM eval forward, 3 batches of
    (8, 2048) through ``make_forward`` with ``attn_impl="auto"`` (the
    model's forward), bf16, on cuda:0. Returns the model and the
    (loss, ms) of each batch."""
    from ompi_release_tpu_torch import entry as tentry
    from ompi_release_tpu_torch.models.transformer import ModelConfig, TpuLM

    model = TpuLM(ModelConfig(), seed=0)
    return model, tentry.run_eval(model)


def check_model_path(torch, model, evals, flash_launches):
    """The 3 losses, then the first batch again through ring attention
    (bf16) and through both paths in f32."""
    import dataclasses
    import math

    from ompi_release_tpu_torch import entry as tentry
    from ompi_release_tpu_torch.models.transformer import make_forward

    cfg = model.cfg
    want = cfg.n_layers * tentry.EVAL_BATCHES
    check(flash_launches == want,
          f"flash_fwd launched {flash_launches} times over "
          f"{tentry.EVAL_BATCHES} batches of {cfg.n_layers} layers, "
          f"not {want}: attn_impl='auto' must take the kernel on the card")
    for i, (loss, _) in enumerate(evals):
        check(math.isfinite(loss) and abs(loss - math.log(cfg.vocab)) < 1.0,
              f"eval batch {i}: loss {loss} not within 1.0 of "
              f"ln({cfg.vocab}) = {math.log(cfg.vocab):.4f}")
    tokens, targets = tentry._batch(cfg, tentry.EVAL_BATCH, tentry.EVAL_SEQ)
    params = model.params()
    ring = float(make_forward(dataclasses.replace(cfg, attn_impl="ring"),
                              model.mesh)(params, tokens, targets))
    flash = evals[0][0]
    check(abs(ring - flash) <= 1e-2 * abs(ring),
          f"bf16 loss: flash {flash} vs ring {ring} (rel 1e-2)")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = {n: t.float() for n, t in params.items() if n != "layers"}
    p32["layers"] = {n: t.float() for n, t in params["layers"].items()}
    losses32 = {impl: float(make_forward(
        dataclasses.replace(cfg32, attn_impl=impl), model.mesh)(
            p32, tokens, targets)) for impl in ("flash", "ring")}
    check(abs(losses32["flash"] - losses32["ring"])
          <= 1e-4 * abs(losses32["ring"]),
          f"f32 loss: flash {losses32['flash']} vs ring "
          f"{losses32['ring']} (rel 1e-4)")
    torch.cuda.synchronize()
    log(json.dumps({"eval_losses": [ls for ls, _ in evals],
                    "ln_vocab": math.log(cfg.vocab), "ring_bf16": ring,
                    "f32": losses32}))
    log(f"phase 3: slice-3 eval forward: {flash_launches} flash launches "
        f"over {tentry.EVAL_BATCHES} batches; losses within 1.0 of "
        "ln(32000); flash == ring (bf16 rel 1e-2, f32 rel 1e-4)")


def drive_train_path():
    """Slice 4's path: the full-width TpuLM train step, TRAIN_STEPS steps
    of ``TpuLM.train_step`` (``adamw(1e-3)``, ``attn_impl="auto"``) on
    one fixed (8, 2048) batch, bf16, on cuda:0. Returns the model and the
    (loss, ms) of each step."""
    from ompi_release_tpu_torch import entry as tentry
    from ompi_release_tpu_torch.models.transformer import ModelConfig, TpuLM

    model = TpuLM(ModelConfig(), seed=0)
    return model, tentry.run_train(model, TRAIN_STEPS)


def check_train_path(torch, model, steps, launches):
    """The launches and losses of the window, then one step's loss and
    gradients from the state it left, through the kernels and through
    ring attention."""
    import dataclasses
    import math

    from ompi_release_tpu_torch import entry as tentry
    from ompi_release_tpu_torch.models.transformer import forward_loss
    from ompi_release_tpu_torch.optim import leaves

    cfg = model.cfg
    want = cfg.n_layers * TRAIN_STEPS
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[name] == want,
              f"{name} launched {launches[name]} times over {TRAIN_STEPS} "
              f"train steps of {cfg.n_layers} layers, not {want}")
    losses = [loss for loss, _ in steps]
    check(all(math.isfinite(x) for x in losses), f"train losses {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    tokens, targets = tentry._batch(cfg, tentry.EVAL_BATCH, tentry.EVAL_SEQ)
    tok = torch.as_tensor(tokens, device=model.device)
    tgt = torch.as_tensor(targets, device=model.device)
    params = model.params()
    names = [n for n in sorted(params) if n != "layers"]
    names = sorted(names + [f"layers/{n}" for n in params["layers"]])
    ts = leaves(params)
    got = {}
    for impl in ("flash", "ring"):
        loss = forward_loss(dataclasses.replace(cfg, attn_impl=impl), params,
                            tok, tgt)
        got[impl] = (float(loss.detach()), torch.autograd.grad(loss, ts))
        del loss
        torch.cuda.empty_cache()
    (lf, gf), (lr, gr) = got["flash"], got["ring"]
    check(abs(lf - lr) <= 1e-2 * abs(lr),
          f"train-step loss: flash {lf} vs ring {lr} (rel 1e-2)")
    rel = {n: float((a.float() - b.float()).norm() / b.float().norm())
           for n, a, b in zip(names, gf, gr)}
    for n, r in rel.items():
        check(r <= 3e-2, f"gradient of {n}: flash vs ring relative L2 "
                         f"error {r} > 3e-2")
    torch.cuda.synchronize()
    log(json.dumps({"train_losses": losses, "flash_vs_ring_loss": [lf, lr],
                    "grad_rel_l2_flash_vs_ring": rel}))
    log(f"phase 3: slice-4 train step: {launches['flash_fwd']} / "
        f"{launches['flash_bwd_dq']} / {launches['flash_bwd_dkv']} flash "
        f"fwd / dq / dkv launches over {TRAIN_STEPS} steps; losses finite and "
        "falling; flash == ring (loss rel 1e-2, gradients rel L2 3e-2)")


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


def time_flash(fa, torch, dev, launches):
    """The flash forward at the main path's (B*H, S, D) = (64, 2048, 64)
    bf16 causal, beside its plain twin and SDPA on the same tensors
    viewed (8, 8, 2048, 64). Bound: 4*N*D*S(S+1)/2 flops at the bf16
    tensor-core peak against q, k, v, o and lse moved once at the HBM
    rate; the f32 CUDA-core floor of the same flops is printed beside it."""
    n, s, d = FLASH_SHAPE
    g = torch.Generator(device=dev).manual_seed(99)
    q, k, v = (torch.randn(n, s, d, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    err = float((fa.flash_forward(q, k, v, True)[0].float()
                 - fa._plain_flash_forward(q, k, v, True)[0].float())
                .abs().max())
    flops = 4 * n * d * s * (s + 1) / 2
    nbytes = 4 * n * s * d * 2 + n * s * 4
    q4, k4, v4 = (t.view(8, n // 8, s, d) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return {
        "name": "flash_fwd", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES, "launches": launches,
        "max_abs_err": err,
        "ms": time_ms(lambda: fa.flash_forward(q, k, v, True), inner=5),
        "plain_ms": time_ms(lambda: fa._plain_flash_forward(q, k, v, True),
                            reps=5),
        "bound_ms": max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3,
        "bound_by": "operations" if flops / BF16_FLOPS
        > nbytes / HBM_BYTES_PER_S else "bytes",
        "library_ms": time_ms(lambda: sdpa(q4, k4, v4, is_causal=True),
                              inner=5),
        "cuda_core_floor_ms": flops / F32_CUDA_CORE_FLOPS * 1e3,
        "shape": list(FLASH_SHAPE), "dtype": "bfloat16", "causal": True,
    }


def time_flash_bwd(fa, torch, dev, launches, hgmma):
    """The two backward kernels at the main path's (B*H, S, D) = (64,
    2048, 64) bf16 causal, each beside its own plain twin, and SDPA's
    backward on the same tensors viewed (8, 8, 2048, 64) (dq, dk and dv
    at once, so it stands in both rows; timed alone with its graph
    retained, its device time from a profiler window). Bound: dq does three (S, S, D) products and dk/dv four, at
    2*N*D*S(S+1)/2 flops each, over the bf16 tensor-core peak, against
    q, k, v, dO, lse, delta read and the outputs written once over the HBM
    rate; the f32 CUDA-core floor of the same flops beside it."""
    n, s, d = FLASH_SHAPE
    g = torch.Generator(device=dev).manual_seed(98)
    q, k, v, do = (torch.randn(n, s, d, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    out, lse = fa.flash_forward(q, k, v, True)
    args = (q, k, v, lse, do, fa._delta(out, do), True)
    q4, k4, v4 = (t.view(8, n // 8, s, d).detach().requires_grad_()
                  for t in (q, k, v))
    o4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4,
                                                           is_causal=True)
    g4 = do.view(8, n // 8, s, d)

    def sdpa_bwd():
        return torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True)

    # autograd's host time per call is about the device's, so CUDA events
    # around the call read host time too: take the kernels' summed device
    # time from a profiler window instead
    for _ in range(2):
        sdpa_bwd()
    torch.cuda.synchronize()
    prof = profile_window(torch, sdpa_bwd, SDPA_BWD_CALLS)
    library_ms = prof["device_busy_ms"] / SDPA_BWD_CALLS
    check(library_ms > 0, f"no device time in SDPA's backward window {prof}")
    log(json.dumps({"profile_sdpa_backward": True, **prof}))
    product = 2 * n * d * s * (s + 1) / 2
    tensor_bytes = n * s * d * 2
    rows = []
    for name, kern, plain, replaces, products, outs in (
            ("flash_bwd_dq", fa._bwd_dq_kernel, fa._plain_bwd_dq,
             DQ_REPLACES, 3, 1),
            ("flash_bwd_dkv", fa._bwd_dkv_kernel, fa._plain_bwd_dkv,
             DKV_REPLACES, 4, 2)):
        got, want = kern(*args), plain(*args)
        if outs == 1:
            got, want = (got,), (want,)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
        flops = products * product
        nbytes = (4 + outs) * tensor_bytes + 2 * n * s * 4
        rows.append({
            "name": name, "route": "cuda", "source": FLASH_BWD_BF16_SOURCE,
            "f32_route_source": FLASH_BWD_SOURCE,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err,
            "ms": time_ms(lambda: kern(*args), inner=5),
            "plain_ms": time_ms(lambda: plain(*args), reps=5),
            "bound_ms": max(flops / BF16_FLOPS,
                            nbytes / HBM_BYTES_PER_S) * 1e3,
            "bound_by": "operations" if flops / BF16_FLOPS
            > nbytes / HBM_BYTES_PER_S else "bytes",
            "library_ms": library_ms,
            "library": "SDPA backward (dq, dk, dv at once)",
            "cuda_core_floor_ms": flops / F32_CUDA_CORE_FLOPS * 1e3,
            "sass_hgmma": hgmma[name],
            "shape": list(FLASH_SHAPE), "dtype": "bfloat16", "causal": True,
        })
    return rows


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


def profile_window(torch, fn, calls):
    """One torch.profiler window of ``calls`` calls of ``fn``: the
    window's host time, the summed device kernel time (busy share = busy
    / window), the launches and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dev_us = lambda e: getattr(  # noqa: E731
        e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    return {"calls": calls, "window_ms": window_ms,
            "device_busy_ms": busy_ms, "busy_share": busy_ms / window_ms,
            "launches": sum(e.count for e in kernels),
            "top": [[e.key[:80], dev_us(e) / 1e3, e.count] for e in top]}


def profile_allreduce(tuned, torch, dev):
    """Where the tuned allreduce's time goes: one profiler window of 3
    calls per size."""
    g = torch.Generator(device=dev).manual_seed(11)
    for nbytes in (4 * MIB, 256 * MIB):
        x = torch.randn(N_RANKS, nbytes // 4, generator=g, device=dev)
        tuned.allreduce(x)
        torch.cuda.synchronize()
        log(json.dumps({"profile_tuned_allreduce_bytes_per_rank": nbytes,
                        **profile_window(torch, lambda: tuned.allreduce(x),
                                         3)}))
        del x


def time_model(torch, model):
    """The eval forward's ms per batch and tokens/s (host clock to a
    synchronize, 3 batches after the phase-3 run warmed it), one
    profiler window over one batch, and the peak device memory."""
    from ompi_release_tpu_torch import entry as tentry

    torch.cuda.reset_peak_memory_stats()
    evals = tentry.run_eval(model, seed=10)
    ms = statistics.median(m for _, m in evals)
    tokens = tentry.EVAL_BATCH * tentry.EVAL_SEQ
    log(json.dumps({"tpulm_eval_ms_per_batch": ms,
                    "ms_each": [m for _, m in evals],
                    "tokens_per_s": tokens / (ms * 1e-3),
                    "batch": [tentry.EVAL_BATCH, tentry.EVAL_SEQ],
                    "peak_device_memory_GiB":
                        torch.cuda.max_memory_allocated() / 2**30}))
    tok, tgt = tentry._batch(model.cfg, tentry.EVAL_BATCH, tentry.EVAL_SEQ)
    tok = torch.as_tensor(tok, device=model.device)
    tgt = torch.as_tensor(tgt, device=model.device)
    log(json.dumps({"profile_tpulm_eval_batch": True,
                    **profile_window(torch, lambda: model(tok, tgt), 1)}))


def time_train(torch, model):
    """The train step's ms per step and tokens/s (host clock to a
    synchronize; median of 3 steps after the slice-4 window warmed it),
    the peak device memory over those steps, and one profiler window
    over one step: busy share, top kernels and host gaps (window minus
    device busy time)."""
    from ompi_release_tpu_torch import entry as tentry

    torch.cuda.reset_peak_memory_stats()
    steps = tentry.run_train(model, 3, seed=10)
    ms = statistics.median(m for _, m in steps)
    tokens = tentry.EVAL_BATCH * tentry.EVAL_SEQ
    log(json.dumps({"tpulm_train_ms_per_step": ms,
                    "ms_each": [m for _, m in steps],
                    "losses": [loss for loss, _ in steps],
                    "tokens_per_s": tokens / (ms * 1e-3),
                    "batch": [tentry.EVAL_BATCH, tentry.EVAL_SEQ],
                    "optimizer": [type(model.opt_state).__name__, {
                        k: model.opt_state.defaults[k]
                        for k in ("lr", "betas", "eps", "weight_decay")}],
                    "peak_device_memory_GiB":
                        torch.cuda.max_memory_allocated() / 2**30}))
    tok, tgt = tentry._batch(model.cfg, tentry.EVAL_BATCH, tentry.EVAL_SEQ,
                             seed=10)
    tok = torch.as_tensor(tok, device=model.device)
    tgt = torch.as_tensor(tgt, device=model.device)
    prof = profile_window(torch, lambda: model.train_step(tok, tgt), 1)
    gap_ms = prof["window_ms"] - prof["device_busy_ms"]
    log(json.dumps({"profile_tpulm_train_step": True, **prof,
                    "host_gap_ms": gap_ms}))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import ompi_release_tpu_torch as mpi
    from ompi_release_tpu_torch.mca import var as tmvar
    from ompi_release_tpu_torch.ops import cuda_op
    from ompi_release_tpu_torch.ops import flash_attention as fa

    # f32 products in full f32 (the plain twins, the f32 loss check)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    log(f"card: {card_line()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32 matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    so = cuda_op.build()
    log(f"phase 1: built {so} in {time.perf_counter() - t0:.2f} s "
        f"from {len(cuda_op.sources())} sources")
    ptxas_report(cuda_op, so)
    hgmma = sass_report(cuda_op, so)

    phase_kernels(cuda_op, torch, dev)
    phase_flash(fa, torch, dev)
    phase_flash_bwd(fa, torch, dev)
    check_bf16_reduction(torch, dev)

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

    cuda_op.reset_launches()
    model, evals = drive_model_path()
    torch.cuda.synchronize()
    launches_model = dict(cuda_op.LAUNCHES)
    log(f"phase 3: slice-3 path launches {launches_model}")
    launches["flash_fwd"] = launches_model["flash_fwd"]
    check_model_path(torch, model, evals, launches["flash_fwd"])
    torch.cuda.empty_cache()

    cuda_op.reset_launches()
    train_model, steps = drive_train_path()
    torch.cuda.synchronize()
    launches_train = dict(cuda_op.LAUNCHES)
    log(f"phase 3: slice-4 path launches {launches_train}")
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        launches[name] = launches_train[name]
    # flash_fwd runs on both model paths: its row counts both windows
    fwd_by_path = {"eval": launches["flash_fwd"],
                   "train": launches_train["flash_fwd"]}
    launches["flash_fwd"] = sum(fwd_by_path.values())
    check_train_path(torch, train_model, steps, launches_train)
    torch.cuda.empty_cache()

    rows = time_kernels(cuda_op, torch, dev, launches)
    rows.append(dict(time_flash(fa, torch, dev, launches["flash_fwd"]),
                     launches_by_path=fwd_by_path))
    rows.extend(time_flash_bwd(fa, torch, dev, launches, hgmma))
    time_allreduce(tuned, torch, dev)
    profile_allreduce(tuned, torch, dev)
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        " GiB")
    time_model(torch, model)
    time_train(torch, train_model)
    del model, train_model
    tuned.free()
    mpi.finalize()
    torch.cuda.empty_cache()
    run_bench(torch, dev)
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(card_line())
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
