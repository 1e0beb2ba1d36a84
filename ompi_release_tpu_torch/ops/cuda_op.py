"""CUDA kernels of the op component and the bench loops.

Counterpart of ``ompi_release_tpu/ops/pallas_op.py``. The reference's
reduction hot loop is a C elementwise loop per (op x dtype)
(``ompi/mca/op/base/op_base_functions.c``); its ``op`` MCA framework
exists so accelerated components can override those loops. This is that
component for an NVIDIA H100, plus the kernels of the bench loops: four
hand-written kernels in ``csrc/stream_ops.cu``, and the tuned ring
allreduce's body as one kernel (``csrc/ring_ops.cu``, :func:`ring_fold`).
:func:`build` compiles every ``csrc/*.cu`` (these five and the
flash-attention forward and backward kernels of
``ops/flash_attention.py``, whose bf16 routes run on
the tensor cores and share ``csrc/wgmma_sm90.cuh``) for ``sm_90a`` with
``nvcc`` at first use into one library under
``ompi_release_tpu_torch/build/``, loaded with ``ctypes``. The library is
named by :func:`library_name`, a hash of every ``csrc/*.cu`` and
``csrc/*.cuh``: an edit to a header rebuilds it too.

- ``stream_axpy``: ``out = acc*c + a``; with ``c == 1`` a plain add, the
  SUM combiner (``sum_``, the ``_pallas_sum_fn`` role) — 3 streams;
- ``stream_scale``: ``out = x*c`` — 2 streams, the copy-rate yardstick;
  both streaming kernels take one 16-byte vector of each operand per
  thread on a grid sized to the work (:func:`stream_plan` is their one
  partition);
- ``tile_transpose_32``: the (rows, cols) -> (cols, rows) transpose of
  32-bit words (``transpose``, the ``make_transpose_loop`` body);
- ``chain_add_one``: ``x + 1`` on one (8, 128) f32 tile (``chain_hop``,
  the ``make_chain_loop`` body);
- ``ring_fold``: the ring allreduce's reduce-scatter and allgather
  passes over a rank-stacked buffer, SUM only, each element's partial
  kept in registers (:func:`ring_fold`; ``coll/spmd.py`` selects it).

Each kernel's wrapper launches it for CUDA tensors and takes its plain
PyTorch twin (``_plain_*``, same arithmetic: f32 math, bf16 widened and
rounded once) only for CPU tensors. There is no fallback: a CUDA tensor
the kernel cannot take raises, and so does a missing ``nvcc``. Wrappers
allocate the output with ``torch.empty_like`` and never write in place
(no aliasing, unlike the Pallas kernels' input/output alias). Every
wrapper, the flash ones included, launches through :func:`_launch`, which
does per call only what the call needs (the host time of one hop of the
chain is its whole cost), checks the C entry's return code and counts
the launch in ``LAUNCHES``; a ``stream_axpy`` launch also counts the
bytes it moves in ``BYTES``. Both are MPI_T pvars (``op_<wrapper>_launches``,
``op_stream_axpy_bytes``).
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
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..mca import component as mca_component
from ..mca import pvar as _pvar
from ..mca import var as mca_var
from ..utils.errors import ErrorCode, MPIError
from .op import OP_FRAMEWORK, SUM

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
#: per-source compile flags; ``-Xptxas -v`` makes ptxas report each
#: kernel's registers, shared memory and spills (kept beside the library)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel launches per wrapper (``sum_``, ``axpy``, ``scale``,
#: ``transpose``, ``chain_hop``, ``ring_fold`` here; ``flash_forward`` and
#: ``flash_backward``'s two kernels in ``flash_attention.py``), bumped only
#: where the wrapper launches its kernel. A launch captured into a CUDA
#: graph counts once, at capture; replays do not pass through the
#: wrapper, except for ``coll/plan.py``'s frozen plans, which move their
#: captured launches to their replays (:func:`take_launches`,
#: :func:`count_replay`)
LAUNCHES: Dict[str, int] = {"sum": 0, "axpy": 0, "scale": 0,
                            "transpose": 0, "chain": 0, "flash_fwd": 0,
                            "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                            "ring_fold": 0}
#: bytes the ``stream_axpy`` launches moved, ``sum_`` and ``axpy`` alike:
#: 3 × n × itemsize a launch (two operands read, one written), counted and
#: moved to a graph's replays as ``LAUNCHES`` is
BYTES: Dict[str, int] = {"stream_axpy_bytes": 0}

for _k in LAUNCHES:
    _pvar.PVARS.register(
        f"op_{_k}_launches", _pvar.PvarClass.COUNTER,
        f"kernel launches of the {_k} wrapper (a captured graph's once "
        "per replay)", getter=lambda k=_k: LAUNCHES[k])
_pvar.PVARS.register(
    "op_stream_axpy_bytes", _pvar.PvarClass.COUNTER,
    "bytes stream_axpy launches moved: 3 x n x itemsize a launch (a "
    "captured graph's once per replay)",
    getter=lambda: BYTES["stream_axpy_bytes"])

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_F32 = torch.float32
_lib: Optional[ctypes.PyDLL] = None
_lib_lock = threading.Lock()
#: what every launch needs: the library, torch's current CUDA device and
#: the raw handle of a device's current stream (the two lookups exist
#: only in CUDA builds of torch: taken at the first launch, never at
#: import)
_launcher: Optional[Tuple[ctypes.PyDLL, Callable[[], int],
                          Callable[[int], int]]] = None


def reset_launches() -> None:
    for d in (LAUNCHES, BYTES):
        for k in d:
            d[k] = 0


def counts() -> Dict[str, int]:
    """A copy of ``LAUNCHES`` and ``BYTES``: the mark :func:`take_launches`
    measures from."""
    return {**LAUNCHES, **BYTES}


def take_launches(before: Dict[str, int]) -> Dict[str, int]:
    """The launches and bytes counted since ``before`` (a copy from
    :func:`counts`; a key it lacks is left where it is), taken back out
    of the counts: a graph capture records its kernels, it does not run
    them."""
    delta: Dict[str, int] = {}
    for d in (LAUNCHES, BYTES):
        for k in d:
            v = d[k] - before.get(k, d[k])
            if v:
                delta[k] = v
                d[k] -= v
    return delta


def count_replay(launches: Dict[str, int]) -> None:
    """Count one replay of a graph that captured ``launches`` (a
    :func:`take_launches` delta)."""
    for k, v in launches.items():
        (BYTES if k in BYTES else LAUNCHES)[k] += v


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
    """Every CUDA source of the port (``csrc/*.cu``), sorted: what
    :func:`build` compiles."""
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def headers() -> List[str]:
    """Every header the sources may include (``csrc/*.cuh``), sorted."""
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_name() -> str:
    """``libport_kernels-<hash>.so``: the hash of the flags and of every
    source and header (names and contents), so a change to any of them,
    or a file added or removed, names another library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources() + headers():
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + b"\0" + fh.read())
    return f"libport_kernels-{h.hexdigest()[:12]}.so"


def build() -> str:
    """Compile every ``csrc/*.cu`` into one shared library and return
    its path. The library is named by :func:`library_name`, so a change
    to any source or header rebuilds and a source added or removed is
    never missing from, or stale in, the library; an unchanged set is
    reused. One ``nvcc -c`` per source runs in parallel, then one link;
    ptxas's report goes to :func:`ptxas_log_path`."""
    srcs = sources()
    out = os.path.join(BUILD_DIR, library_name())
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


def _load() -> ctypes.PyDLL:
    """The kernels' library, built and bound at the first call. Once it
    is loaded it is returned without the lock; the lock only keeps two
    first calls from loading it twice. Its entries keep the GIL (a
    ``PyDLL``): each returns as soon as its kernel is queued, as
    PyTorch's own launches do, so releasing the GIL would only add the
    cost of taking it back."""
    global _lib
    lib = _lib
    if lib is not None:
        return lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.PyDLL(build())
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
            lib.ring_fold.argtypes = [ctypes.c_int, vp, vp, ctypes.c_int,
                                      ctypes.c_longlong, ctypes.c_longlong,
                                      ctypes.c_longlong, vp]
            lib.ring_fold.restype = ctypes.c_int
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
            for fn in ("flash_fwd_smem_bytes", "flash_fwd_bf16_smem_bytes",
                       "flash_bwd_dq_smem_bytes",
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
        if t.get_device() != t0.get_device() or t.dtype != t0.dtype \
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


def _launch_state() -> Tuple[ctypes.PyDLL, Callable[[], int],
                             Callable[[int], int]]:
    global _launcher
    if _launcher is None:
        _launcher = (_load(), torch._C._cuda_getDevice,
                     torch._C._cuda_getCurrentRawStream)
    return _launcher


def _launch(kernel: str, counter: str, device: int, *args) -> None:
    """Launch the library's C entry ``kernel`` on ``args`` and the raw
    handle of CUDA device ``device``'s current stream, then count it in
    ``LAUNCHES[counter]``. Per call it reads the stream handle afresh
    (a launch inside ``torch.cuda.stream(side)`` or a graph capture goes
    to that stream), takes the device guard only when ``device`` is not
    the current device, and raises ``MPIError`` naming the kernel on a
    non-zero return, before counting."""
    if device < 0:
        raise MPIError(ErrorCode.ERR_ARG,
                       f"{kernel}: the kernel takes CUDA tensors")
    lib, current_device, raw_stream = _launcher or _launch_state()
    if current_device() == device:
        err = getattr(lib, kernel)(*args, raw_stream(device))
    else:
        with torch.cuda.device(device):
            err = getattr(lib, kernel)(*args, raw_stream(device))
    if err:
        raise MPIError(ErrorCode.ERR_OTHER,
                       f"{kernel} launch failed: CUDA error {err}")
    LAUNCHES[counter] += 1


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


def _plain_ring_fold(x: torch.Tensor, n: int, seg: int,
                     chunk: int) -> torch.Tensor:
    """The ring's fold written out: position ``p`` of a rank's buffer is
    in chunk ``j = (p % seg) // chunk``, completed as ``acc = x[j]``,
    then ``acc = x[(j + t) % n] + acc`` for t = 1..n-1 (the SUM
    combiner's rounding at every step), and copied to every rank."""
    flat = x.reshape(n, -1)
    j = (torch.arange(flat.shape[1], device=x.device) % seg) // chunk
    acc = flat.gather(0, j[None])
    for t in range(1, n):
        acc = _plain_sum(flat.gather(0, ((j + t) % n)[None]), acc)
    return acc.expand(n, -1).reshape(x.shape).contiguous()


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
    _launch("stream_axpy", wrapper, a.get_device(), _DTYPE_CODE[a.dtype],
            a.data_ptr(), acc.data_ptr(), out.data_ptr(), float(c),
            int(plain_add), n)
    BYTES["stream_axpy_bytes"] += 3 * n * a.element_size()
    return out


def axpy(a: torch.Tensor, acc: torch.Tensor, c: float = 1.0) -> torch.Tensor:
    """``acc*c + a`` (the AXPY hot loop); equal-shape f32/bf16 tensors."""
    if a.is_cpu:
        return _plain_axpy(a, acc, c)
    return _launch_axpy(a, acc, c, plain_add=False, wrapper="axpy")


def sum_(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``b + a``: the SUM combiner (``_pallas_sum_fn`` role) — the axpy
    kernel's ``c == 1`` path, one IEEE add per element."""
    if a.is_cpu:
        return _plain_sum(a, b)
    return _launch_axpy(a, b, 1.0, plain_add=True, wrapper="sum")


#: threads per block of the streaming kernels (``csrc/stream_ops.cu``)
STREAM_THREADS = 256


def stream_plan(n: int, itemsize: int, *addrs: int) -> Tuple[int, int, int]:
    """``(unit, units, grid)``: how ``stream_axpy`` and ``stream_scale``
    split ``n`` elements of ``itemsize`` bytes between their operands at
    ``addrs`` (inputs and output; a copy of the C ``stream_plan`` in
    ``csrc/stream_ops.cu``, for the host's tests of the partition).
    Thread ``i`` of the ``grid`` blocks of ``STREAM_THREADS`` does
    elements ``[i * unit, (i + 1) * unit)`` of every operand if ``i <
    units``: one 16-byte vector (``unit = 16 // itemsize``) when every
    address is 16-byte aligned, else one element (``unit = 1``). The
    ``n - units * unit`` elements after the last whole vector (fewer
    than ``unit``) go to block 0's first threads."""
    unit = 1 if any(addr % 16 for addr in addrs) else 16 // itemsize
    units = n // unit
    return unit, units, max(-(-units // STREAM_THREADS), 1)


def stream_boundary_sizes(itemsize: int) -> List[int]:
    """Sizes at the edges of :func:`stream_plan`'s partition: one vector
    (``16 // itemsize`` elements), one block of vectors and a grid of
    4,097 blocks (several waves on an H100), each minus one, exact and
    plus one, and the grid with the longest tail after its last vector."""
    vec = 16 // itemsize
    block = STREAM_THREADS * vec
    grid = 4097 * block
    return [vec - 1, vec, vec + 1, block - 1, block, block + 1,
            grid - 1, grid, grid + 1, grid + vec - 1]


def scale(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x*c`` streaming (read + write: the copy-rate kernel)."""
    if x.is_cpu:
        return _plain_scale(x, c)
    _check("stream_scale", x)
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    _launch("stream_scale", "scale", x.get_device(), _DTYPE_CODE[x.dtype],
            x.data_ptr(), out.data_ptr(), float(c), n)
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
    if x.is_cpu:
        return _plain_transpose(x)
    if not x.is_contiguous():
        raise MPIError(ErrorCode.ERR_ARG,
                       "transpose: the kernel takes contiguous tensors")
    rows, cols = x.shape
    out = torch.empty((cols, rows), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    _launch("tile_transpose_32", "transpose", x.get_device(), x.data_ptr(),
            out.data_ptr(), rows, cols)
    return out


def chain_hop(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` on one contiguous (8, 128) float32 tile: one hop of the
    ring analogue (one launch, dependent on the previous hop)."""
    if x.shape != CHAIN_TILE or x.dtype is not _F32:
        raise MPIError(ErrorCode.ERR_TYPE,
                       f"chain_hop: the kernel takes one {CHAIN_TILE} "
                       f"float32 tile, got {tuple(x.shape)} {x.dtype}")
    if x.is_cpu:
        return _plain_chain_hop(x)
    ptr = x.data_ptr()
    if ptr % 16 or not x.is_contiguous():
        raise MPIError(ErrorCode.ERR_ARG,
                       "chain_hop: the kernel takes a contiguous, 16-byte "
                       "aligned tile")
    out = torch.empty_like(x)
    _launch("chain_add_one", "chain", x.get_device(), ptr, out.data_ptr())
    return out


def ring_fold(x: torch.Tensor, n: int, seg: int, chunk: int) -> torch.Tensor:
    """The ring allreduce of SUM over the ``n`` rank rows of ``x``
    (``(n, ...)``, f32 or bf16), both passes in one kernel
    (``csrc/ring_ops.cu``), bitwise ``coll/spmd.py``'s interpreted
    ring: position ``p`` of a rank's buffer is in chunk ``(p % seg) //
    chunk``, and the chunk's index alone fixes the order its ``n``
    values are added in. ``seg`` is the segmented ring's segment length,
    the buffer's length for the plain ring; ``chunk`` is ``ceil(seg /
    n)``. A new tensor; ``x`` is never written."""
    if x.dim() == 0 or x.shape[0] != n or n < 2 or seg < 1 or chunk < 1 \
            or chunk * n < seg:
        raise MPIError(ErrorCode.ERR_ARG,
                       f"ring_fold: needs an (n, ...) buffer, n >= 2 and "
                       f"chunk * n >= seg (shape {tuple(x.shape)}, n {n}, "
                       f"seg {seg}, chunk {chunk})")
    if x.is_cpu:
        return _plain_ring_fold(x, n, seg, chunk)
    _check("ring_fold", x)
    out = torch.empty_like(x)
    total = x.numel() // n
    if total == 0:
        return out
    _launch("ring_fold", "ring_fold", x.get_device(), _DTYPE_CODE[x.dtype],
            x.data_ptr(), out.data_ptr(), n, total, seg, chunk)
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


def claims_ring(op, dtype) -> bool:
    """Whether :func:`ring_fold` may run a ring allreduce under ``op`` in
    ``dtype``: the ring kernel's claim, made here as
    :meth:`CudaOpComponent.lookup` makes the streaming kernel's. SUM —
    the built-in ``SUM`` or this component's ``sum[cuda]``, by object,
    never by name, since the kernel hard-wires SUM's arithmetic — in f32
    or bf16, while the component is available: ``--mca op ^cuda`` keeps
    every ring on its interpreted passes. No size threshold:
    ``op_cuda_threshold`` is where one streaming add beats PyTorch's,
    and the kernel replaces a whole interpreted ring at every size."""
    if dtype not in _DTYPE_CODE or (op is not SUM
                                    and op is not make_cuda_sum()):
        return False
    return any(comp.NAME == CudaOpComponent.NAME
               for _prio, comp, _module in OP_FRAMEWORK.available())


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
