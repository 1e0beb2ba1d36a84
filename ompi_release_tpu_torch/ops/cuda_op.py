"""CUDA kernels of the op component and the bench loops.

Counterpart of ``ompi_release_tpu/ops/pallas_op.py``. The reference's
reduction hot loop is a C elementwise loop per (op x dtype)
(``ompi/mca/op/base/op_base_functions.c``); its ``op`` MCA framework
exists so accelerated components can override those loops. This is that
component for an NVIDIA H100, plus the kernels of the bench loops: four
hand-written kernels in ``csrc/stream_ops.cu``. :func:`build` compiles
every ``csrc/*.cu`` (these four and the flash-attention forward and
backward kernels of ``ops/flash_attention.py``, the bf16 backward on the
tensor cores) for ``sm_90a`` with
``nvcc`` at first use into one library under
``ompi_release_tpu_torch/build/``, loaded with ``ctypes``:

- ``stream_axpy``: ``out = acc*c + a``; with ``c == 1`` a plain add, the
  SUM combiner (``sum_``, the ``_pallas_sum_fn`` role) — 3 streams;
- ``stream_scale``: ``out = x*c`` — 2 streams, the copy-rate yardstick;
- ``tile_transpose_32``: the (rows, cols) -> (cols, rows) transpose of
  32-bit words (``transpose``, the ``make_transpose_loop`` body);
- ``chain_add_one``: ``x + 1`` on one (8, 128) f32 tile (``chain_hop``,
  the ``make_chain_loop`` body).

Each kernel's wrapper launches it for CUDA tensors and takes its plain
PyTorch twin (``_plain_*``, same arithmetic: f32 math, bf16 widened and
rounded once) only for CPU tensors. There is no fallback: a CUDA tensor
the kernel cannot take raises, and so does a missing ``nvcc``. Wrappers
allocate the output with ``torch.empty_like`` and never write in place
(no aliasing, unlike the Pallas kernels' input/output alias). Each
wrapper counts its kernel launches in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List, Optional

import torch

from ..mca import component as mca_component
from ..mca import var as mca_var
from ..utils.errors import ErrorCode, MPIError

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
#: per-source compile flags; ``-Xptxas -v`` makes ptxas report each
#: kernel's registers, shared memory and spills (kept beside the library)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel launches per wrapper (``sum_``, ``axpy``, ``scale``,
#: ``transpose``, ``chain_hop`` here; ``flash_forward`` and
#: ``flash_backward``'s two kernels in ``flash_attention.py``), bumped only
#: where the wrapper launches its kernel (a launch captured into a CUDA
#: graph counts once, at capture; replays do not pass through the wrapper)
LAUNCHES: Dict[str, int] = {"sum": 0, "axpy": 0, "scale": 0,
                            "transpose": 0, "chain": 0, "flash_fwd": 0,
                            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise MPIError(ErrorCode.ERR_NOT_AVAILABLE,
                   "nvcc not found (set CUDA_HOME): the CUDA kernels are "
                   "built from csrc/*.cu at first use")


def sources() -> List[str]:
    """Every CUDA source of the port (``csrc/*.cu``), sorted."""
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def build() -> str:
    """Compile every ``csrc/*.cu`` into one shared library and return
    its path. The library is named by the hash of all sources (names and
    contents) and flags, so a change to any source rebuilds and a source
    added or removed is never missing from, or stale in, the library; an
    unchanged set is reused. One ``nvcc -c`` per source runs in parallel,
    then one link; ptxas's report goes to :func:`ptxas_log_path`."""
    srcs = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode() + b"\0" + fh.read())
    out = os.path.join(BUILD_DIR, f"libport_kernels-{h.hexdigest()[:12]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmpdir = tempfile.mkdtemp(prefix="objs-", dir=BUILD_DIR)
    try:
        nvcc = _nvcc()
        objs, procs = [], []
        for src in srcs:
            obj = os.path.join(tmpdir, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = [proc.communicate()[0] for _, proc in procs]  # wait for all
        for (cmd, proc), text in zip(procs, logs):
            if proc.returncode != 0:
                raise MPIError(ErrorCode.ERR_OTHER,
                               f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{text}")
        tmp = os.path.join(tmpdir, "lib.so")
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise MPIError(ErrorCode.ERR_OTHER,
                           f"nvcc link failed ({res.returncode}): "
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        with open(ptxas_log_path(out), "w") as fh:
            fh.write("".join(logs))
        # atomic: a concurrent build never sees half a file
        os.replace(tmp, out)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return out


def ptxas_log_path(lib: str) -> str:
    """Where :func:`build` keeps ptxas's ``-v`` report for ``lib``."""
    return lib[:-len(".so")] + ".ptxas.txt"


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp = ctypes.c_void_p
            lib.stream_axpy.argtypes = [ctypes.c_int, vp, vp, vp,
                                        ctypes.c_float, ctypes.c_int,
                                        ctypes.c_longlong, vp]
            lib.stream_axpy.restype = ctypes.c_int
            lib.stream_scale.argtypes = [ctypes.c_int, vp, vp,
                                         ctypes.c_float, ctypes.c_longlong,
                                         vp]
            lib.stream_scale.restype = ctypes.c_int
            lib.tile_transpose_32.argtypes = [vp, vp, ctypes.c_longlong,
                                              ctypes.c_longlong, vp]
            lib.tile_transpose_32.restype = ctypes.c_int
            lib.chain_add_one.argtypes = [vp, vp, vp]
            lib.chain_add_one.restype = ctypes.c_int
            lib.flash_fwd.argtypes = [ctypes.c_int, vp, vp, vp, vp, vp,
                                      ctypes.c_longlong, ctypes.c_longlong,
                                      ctypes.c_int, ctypes.c_float,
                                      ctypes.c_int, vp]
            lib.flash_fwd.restype = ctypes.c_int
            lib.flash_bwd_dq.argtypes = [ctypes.c_int, vp, vp, vp, vp, vp,
                                         vp, vp, ctypes.c_longlong,
                                         ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_float, ctypes.c_int, vp]
            lib.flash_bwd_dq.restype = ctypes.c_int
            lib.flash_bwd_dkv.argtypes = [ctypes.c_int, vp, vp, vp, vp, vp,
                                          vp, vp, vp, ctypes.c_longlong,
                                          ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_float, ctypes.c_int, vp]
            lib.flash_bwd_dkv.restype = ctypes.c_int
            for fn in ("flash_fwd_smem_bytes", "flash_bwd_dq_smem_bytes",
                       "flash_bwd_dkv_smem_bytes",
                       "flash_bwd_dq_bf16_smem_bytes",
                       "flash_bwd_dkv_bf16_smem_bytes"):
                getattr(lib, fn).argtypes = [ctypes.c_int]
                getattr(lib, fn).restype = ctypes.c_longlong
            _lib = lib
        return _lib


def _check(name: str, *ts: torch.Tensor) -> None:
    t0 = ts[0]
    for t in ts:
        if t.device != t0.device or t.dtype != t0.dtype \
                or t.shape != t0.shape:
            raise MPIError(ErrorCode.ERR_ARG,
                           f"{name}: operands differ in device, dtype or "
                           f"shape ({t0.device}/{t0.dtype}/{tuple(t0.shape)}"
                           f" vs {t.device}/{t.dtype}/{tuple(t.shape)})")
        if not t.is_contiguous():
            raise MPIError(ErrorCode.ERR_ARG,
                           f"{name}: the kernel takes contiguous tensors")
    if t0.dtype not in _DTYPE_CODE:
        raise MPIError(ErrorCode.ERR_TYPE,
                       f"{name}: the kernel takes float32/bfloat16, got "
                       f"{t0.dtype}")


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise MPIError(ErrorCode.ERR_OTHER,
                       f"{name} launch failed: CUDA error {err}")


# ---------------------------------------------------------------------------
# plain PyTorch twins (the CPU path; the card compares the kernels to them)
# ---------------------------------------------------------------------------

def _plain_axpy(a: torch.Tensor, acc: torch.Tensor, c: float) -> torch.Tensor:
    if a.dtype is torch.bfloat16:
        return (acc.float() * c + a.float()).to(torch.bfloat16)
    return acc * c + a


def _plain_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dtype is torch.bfloat16:
        return (b.float() + a.float()).to(torch.bfloat16)
    return b + a


def _plain_scale(x: torch.Tensor, c: float) -> torch.Tensor:
    if x.dtype is torch.bfloat16:
        return (x.float() * c).to(torch.bfloat16)
    return x * c


def _plain_transpose(x: torch.Tensor) -> torch.Tensor:
    return x.t().contiguous()


def _plain_chain_hop(x: torch.Tensor) -> torch.Tensor:
    return x + 1


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _launch_axpy(a, acc, c: float, plain_add: bool,
                 wrapper: str) -> torch.Tensor:
    _check("stream_axpy", a, acc)
    out = torch.empty_like(acc)
    n = a.numel()
    if n == 0:
        return out
    lib = _load()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.stream_axpy(_DTYPE_CODE[a.dtype], a.data_ptr(),
                              acc.data_ptr(), out.data_ptr(), float(c),
                              int(plain_add), n, stream)
    _raise_on("stream_axpy", err)
    LAUNCHES[wrapper] += 1
    return out


def axpy(a: torch.Tensor, acc: torch.Tensor, c: float = 1.0) -> torch.Tensor:
    """``acc*c + a`` (the AXPY hot loop); equal-shape f32/bf16 tensors."""
    if a.device.type == "cpu":
        return _plain_axpy(a, acc, c)
    return _launch_axpy(a, acc, c, plain_add=False, wrapper="axpy")


def sum_(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``b + a``: the SUM combiner (``_pallas_sum_fn`` role) — the axpy
    kernel's ``c == 1`` path, one IEEE add per element."""
    if a.device.type == "cpu":
        return _plain_sum(a, b)
    return _launch_axpy(a, b, 1.0, plain_add=True, wrapper="sum")


def scale(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x*c`` streaming (read + write: the copy-rate kernel)."""
    if x.device.type == "cpu":
        return _plain_scale(x, c)
    _check("stream_scale", x)
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    lib = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.stream_scale(_DTYPE_CODE[x.dtype], x.data_ptr(),
                               out.data_ptr(), float(c), n, stream)
    _raise_on("stream_scale", err)
    LAUNCHES["scale"] += 1
    return out


#: element types the transpose kernel moves as 32-bit words
_WORD32 = (torch.int32, torch.float32)
#: the chain kernel's one tile (pallas_op.make_chain_loop's block)
CHAIN_TILE = (8, 128)


def transpose(x: torch.Tensor) -> torch.Tensor:
    """``x.T`` as a new contiguous tensor: a 2-D int32/float32 tensor
    (rows, cols) -> (cols, rows). Any shape; the kernel masks the
    ragged edge tiles."""
    if x.dim() != 2 or x.dtype not in _WORD32:
        raise MPIError(ErrorCode.ERR_TYPE,
                       f"transpose: the kernel takes a 2-D int32/float32 "
                       f"tensor, got {tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return _plain_transpose(x)
    if not x.is_contiguous():
        raise MPIError(ErrorCode.ERR_ARG,
                       "transpose: the kernel takes contiguous tensors")
    rows, cols = x.shape
    out = torch.empty((cols, rows), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    lib = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tile_transpose_32(x.data_ptr(), out.data_ptr(), rows,
                                    cols, stream)
    _raise_on("tile_transpose_32", err)
    LAUNCHES["transpose"] += 1
    return out


def chain_hop(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` on one contiguous (8, 128) float32 tile: one hop of the
    ring analogue (one launch, dependent on the previous hop)."""
    if tuple(x.shape) != CHAIN_TILE or x.dtype is not torch.float32:
        raise MPIError(ErrorCode.ERR_TYPE,
                       f"chain_hop: the kernel takes one {CHAIN_TILE} "
                       f"float32 tile, got {tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return _plain_chain_hop(x)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise MPIError(ErrorCode.ERR_ARG,
                       "chain_hop: the kernel takes a contiguous, 16-byte "
                       "aligned tile")
    out = torch.empty_like(x)
    lib = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.chain_add_one(x.data_ptr(), out.data_ptr(), stream)
    _raise_on("chain_add_one", err)
    LAUNCHES["chain"] += 1
    return out


# ---------------------------------------------------------------------------
# op-framework component
# ---------------------------------------------------------------------------

def _cuda_sum_fn(a, b):
    """SUM combiner of the ``sum[cuda]`` op: the collectives' local
    reduction step. Operands are made contiguous first (the role of the
    Pallas kernel's flatten/pad prologue); equal shapes only."""
    return sum_(a.contiguous(), b.contiguous())


_cuda_sum_op = None


def make_cuda_sum():
    # ONE Op instance for the component's lifetime: program caches key
    # collectives by the op OBJECT, so a fresh Op per lookup would miss
    # the cache on every resolved call
    global _cuda_sum_op
    if _cuda_sum_op is None:
        from .op import Op

        _cuda_sum_op = Op("sum[cuda]", _cuda_sum_fn, commutative=True,
                          identity=lambda d: 0)
    return _cuda_sum_op


class CudaOpComponent(mca_component.Component):
    """Claims large contiguous f32/bf16 SUM reductions; everything else
    falls through to the torch component (counterpart of
    ``PallasOpComponent``, same claim rule and default threshold)."""

    NAME = "cuda"
    PRIORITY = 20  # outranks torch (10): queried first, claims narrowly

    def register_vars(self) -> None:
        mca_var.register(
            "op_cuda_threshold", "size", 4 * 1024 * 1024,
            "Minimum reduction size in bytes for the CUDA streaming SUM "
            "kernel to claim the op",
        )

    def lookup(self, name: str, dtype=None, nbytes: int = 0):
        if name != "sum" or dtype not in _DTYPE_CODE:
            return None
        if nbytes < int(mca_var.get("op_cuda_threshold", 4 * 1024 * 1024)):
            return None
        return make_cuda_sum()


# ---------------------------------------------------------------------------
# bench loops (pallas_op.make_axpy_loop / make_scale_loop counterparts)
# ---------------------------------------------------------------------------

def make_axpy_loop(rows: int, cols: int, c: float = 0.999,
                   dtype=torch.float32):
    """K launches of the axpy kernel over a (rows, cols) accumulator
    (per-iteration traffic 3 x rows x cols x itemsize); returns the
    ``acc[0, 0] + acc[-1, -1]`` checksum. Each launch is opaque, so no
    algebraic folding across iterations can shortcut the traffic."""

    def loop(a: torch.Tensor, k: int) -> torch.Tensor:
        acc = torch.zeros((rows, cols), dtype=dtype, device=a.device)
        for _ in range(k):
            acc = axpy(a, acc, c)
        return acc[0, 0] + acc[-1, -1]

    return loop


def make_scale_loop(rows: int, cols: int, c: float = 1.0001,
                    dtype=torch.float32):
    """K launches of the 2-stream scale kernel (read + write per
    iteration: the copy-rate yardstick); same checksum."""

    def loop(a: torch.Tensor, k: int) -> torch.Tensor:
        if a.shape != (rows, cols) or a.dtype != dtype:
            raise MPIError(ErrorCode.ERR_ARG,
                           f"scale loop built for {(rows, cols)} {dtype}")
        acc = a
        for _ in range(k):
            acc = scale(acc, c)
        return acc[0, 0] + acc[-1, -1]

    return loop


def make_transpose_loop(n: int, dtype=torch.int32):
    """``(loop, call)`` over an (n, n) transpose: ``call`` is one
    :func:`transpose`; ``loop(a, k)`` applies it TWICE per iteration, so
    callers count ``4 * n * n * itemsize`` bytes per iteration as
    bench.py does. The JAX loop double-applies so that XLA does not copy
    the loop carry (``pallas_op.py:275-290``); here it only keeps the
    byte count and the checksum: T(T(a)) = a, so ``acc[0, 0] +
    acc[-1, -1]`` equals ``a[0, 0] + a[-1, -1]`` for every k."""

    def loop(a: torch.Tensor, k: int) -> torch.Tensor:
        if a.shape != (n, n) or a.dtype != dtype:
            raise MPIError(ErrorCode.ERR_ARG,
                           f"transpose loop built for {(n, n)} {dtype}")
        acc = a
        for _ in range(k):
            acc = transpose(transpose(acc))
        return acc[0, 0] + acc[-1, -1]

    return loop, transpose


#: iterations one captured graph holds (make_chain_loop(graph=True)):
#: a whole K_hi (~10^5 iterations) would be a graph that is slow to
#: instantiate, so a fixed block is captured once and replayed
GRAPH_BLOCK = 256


def make_chain_loop(hops: int = 4, graph: bool = False):
    """``loop(a, k)``: ``k * hops`` serially dependent :func:`chain_hop`
    launches on an (8, 128) f32 tile — the single-chip analogue of
    ring_c.c's token ring; slope / hops is the per-hop latency. Returns
    ``acc[0, 0] + acc[-1, -1]``, which is ``a[0, 0] + a[-1, -1] +
    2 * hops * k`` (exact in f32 while below 2^24).

    ``graph=False`` launches every hop from Python (what a Python caller
    pays). ``graph=True`` captures ``GRAPH_BLOCK`` iterations once per
    device with ``torch.cuda.graph`` and replays it ``k // GRAPH_BLOCK``
    times, the remaining iterations eager: the analogue of the JAX
    loop's single compiled ``fori_loop``. It needs a CUDA tensor."""
    graphs: Dict[torch.device, tuple] = {}

    def eager(acc: torch.Tensor, k: int) -> torch.Tensor:
        for _ in range(k * hops):
            acc = chain_hop(acc)
        return acc

    def capture(a: torch.Tensor) -> tuple:
        static = a.clone()
        side = torch.cuda.Stream(a.device)
        side.wait_stream(torch.cuda.current_stream(a.device))
        with torch.cuda.stream(side):  # warm up (loads the kernel) off
            eager(static, 1)           # the capture, as torch requires
        torch.cuda.current_stream(a.device).wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            static.copy_(eager(static, GRAPH_BLOCK))  # out feeds the next
        return g, static                              # replay's input

    def loop(a: torch.Tensor, k: int) -> torch.Tensor:
        if not graph:
            acc = eager(a, k)
            return acc[0, 0] + acc[-1, -1]
        if a.device.type != "cuda":
            raise MPIError(ErrorCode.ERR_NOT_AVAILABLE,
                           "make_chain_loop(graph=True) replays a CUDA "
                           f"graph: it needs a CUDA tensor, got {a.device}")
        if a.device not in graphs:
            graphs[a.device] = capture(a)
        g, static = graphs[a.device]
        static.copy_(a)
        for _ in range(k // GRAPH_BLOCK):
            g.replay()
        acc = eager(static, k % GRAPH_BLOCK)
        return acc[0, 0] + acc[-1, -1]

    return loop
