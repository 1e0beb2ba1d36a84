"""Sharded array save/load — the ompio/fcoll two-phase path, in-process.

Counterpart of ``ompi_release_tpu/io/sharded.py``: each rank's block (or
each chunk of a flattened array) is written as its own ``.npy`` object
in parallel on a thread pool, with a manifest describing the layout for
reassembly. The files are the JAX package's, byte for byte: the same
``np.save`` of the same numpy dtype and shape (so the same header and
the same crc32 over it), bf16 written as float32 with manifest dtype
``"bfloat16"``, the same flat/axis0 layouts and shard counts
(``io_target_shard_bytes``). A checkpoint written by one package
restores in the other: :func:`save_pytree` numbers its leaves in
``jax.tree.flatten``'s order (``utils/pytree.py``). The ``treedef``
string of ``pytree.json`` is the one field that may differ.

Loads return CPU tensors (bf16 read back to ``torch.bfloat16``);
:func:`load_pytree` puts each leaf on its ``like`` leaf's device and
dtype. A tensor on the card is pulled to the host one shard at a time.
An asynchronous save copies its input before it returns (the port's
tensors are mutable, JAX's arrays are not): a caller that updates the
tensor in place afterwards does not change what is written.

Not ported yet: the obs spans of a shard read or write (ROADMAP queue 1
item 16).
"""

from __future__ import annotations

import gzip
import io as _io
import json
import os
import threading
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, List, Optional

import numpy as np
import torch

from ..mca import pvar
from ..mca import var as mca_var
from ..utils import pytree
from ..utils.arrays import host_tensor, numpy_name, to_numpy, torch_dtype
from ..utils.errors import ErrorCode, MPIError

_bytes_written = pvar.counter("io_bytes_written", "sharded-IO bytes written")
_bytes_read = pvar.counter("io_bytes_read", "sharded-IO bytes read")

_pool: Optional[ThreadPoolExecutor] = None
_pool_lock = threading.Lock()


def register_vars() -> None:
    mca_var.register(
        "io_num_aggregators", "int", 8,
        "Concurrent shard writers (fcoll two_phase aggregator count)",
    )
    mca_var.register(
        "io_compress", "enum", "none",
        "Shard compression (opal/mca/compress analogue)",
        choices=("none", "gzip"),
    )
    mca_var.register(
        "io_checksum", "bool", True,
        "CRC32 per shard, verified on load (opal datatype-checksum "
        "analogue: catches storage corruption)",
    )
    mca_var.register(
        "io_target_shard_bytes", "size", 64 * 1024 * 1024,
        "Target bytes per shard for flat-layout saves (pytree leaves): "
        "a leaf splits into ceil(nbytes/target) contiguous chunks",
    )


register_vars()  # idempotent; io vars must exist before any save/load
# reads them (an unregistered var silently reads as its default)


def _executor() -> ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(
                max_workers=int(mca_var.get("io_num_aggregators", 8)),
                thread_name_prefix="ompitpu-io",
            )
        return _pool


def _as_tensor(x) -> torch.Tensor:
    return x.detach() if isinstance(x, torch.Tensor) else host_tensor(x)


def _snapshot(x: torch.Tensor):
    """(a copy of ``x`` as it is now, the event the writers wait on
    before they read a copy on the card, or None)."""
    x = x.clone()
    if not x.is_cuda:
        return x, None
    ready = torch.cuda.Event()
    ready.record()
    return x, ready


def save_sharded(path: str, x, *, name: str = "array",
                 async_: bool = False, layout: str = "axis0",
                 num_shards: Optional[int] = None):
    """Write an array (a tensor or a host array) as N .npy shards + a
    manifest.

    layout="axis0": one shard per leading-axis slice (each rank's block
    is its own object). layout="flat": the array is flattened and split
    into ``num_shards`` contiguous chunks (default: ceil(nbytes /
    io_target_shard_bytes)) — the right layout for model parameters,
    where axis 0 (e.g. a 32k vocab) would otherwise produce one tiny
    file per row.

    Device shards are pulled per shard, so at most one shard per writer
    is host-resident at a time. Returns a Future list when ``async_``
    (wait with ``[f.result() for f in futs]``), else writes
    synchronously.
    """
    x, ready = _snapshot(_as_tensor(x)) if async_ else (_as_tensor(x), None)
    return _save(path, x, ready, name=name, async_=async_, layout=layout,
                 num_shards=num_shards)


def _save(path: str, x: torch.Tensor, ready, *, name: str, async_: bool,
          layout: str, num_shards: Optional[int]):
    """:func:`save_sharded` of ``x``, which the caller does not change
    while the writers run; on the card they wait for ``ready``."""
    os.makedirs(path, exist_ok=True)
    bf16 = x.dtype is torch.bfloat16
    if layout == "flat":
        nbytes = x.numel() * (4 if bf16 else x.element_size())
        if num_shards is None:
            target = int(mca_var.get("io_target_shard_bytes",
                                     64 * 1024 * 1024))
            num_shards = max(1, -(-nbytes // max(1, target)))
        n = min(int(num_shards), max(1, x.numel()))
        bounds = np.linspace(0, x.numel(), n + 1).astype(np.int64)
        xflat = x.reshape(-1)
    elif layout == "axis0":
        n = int(x.shape[0])
        bounds = None
    else:
        raise MPIError(ErrorCode.ERR_ARG, f"unknown layout {layout!r}")
    compress = str(mca_var.get("io_compress", "none"))
    checksum = bool(mca_var.get("io_checksum", True))
    manifest = {
        "name": name,
        "dtype": numpy_name(x.dtype),
        "shape": list(x.shape),
        "num_shards": n,
        "compress": compress,
        "layout": layout,
        "version": 3,
    }
    crcs: List[Optional[int]] = [None] * n

    def write_one(i: int) -> int:
        if ready is not None:
            ready.synchronize()
        src = (xflat[int(bounds[i]):int(bounds[i + 1])]
               if layout == "flat" else x[i])
        block = to_numpy(src)  # bf16 widened to f32, as JAX's astype
        buf = _io.BytesIO()
        np.save(buf, block)
        raw = buf.getvalue()
        if checksum:
            crcs[i] = zlib.crc32(raw)
        fn = os.path.join(path, f"{name}.shard{i:05d}.npy")
        opener = gzip.open if compress == "gzip" else open
        with opener(fn, "wb") as f:
            f.write(raw)
        _bytes_written.add(block.nbytes)
        return block.nbytes

    ex = _executor()
    futs = [ex.submit(write_one, i) for i in range(n)]

    def finish() -> None:
        if checksum:
            manifest["crc32"] = crcs
        with open(os.path.join(path, f"{name}.manifest.json"), "w") as f:
            json.dump(manifest, f)

    if async_:
        writers = list(futs)

        def wait_then_finish() -> int:
            # FIFO pool: writers were submitted first, so this task only
            # runs after a worker frees up — no self-deadlock
            for f in writers:
                f.result()
            finish()
            return 0

        futs.append(ex.submit(wait_then_finish))
        return futs
    for f in futs:
        f.result()
    finish()
    return None


def load_sharded(path: str, *, name: str = "array") -> torch.Tensor:
    """Reassemble a sharded array (parallel shard reads) as a CPU
    tensor."""
    mf = os.path.join(path, f"{name}.manifest.json")
    if not os.path.exists(mf):
        raise MPIError(ErrorCode.ERR_FILE, f"no manifest at {mf}")
    with open(mf) as f:
        manifest = json.load(f)
    n = manifest["num_shards"]
    compress = manifest.get("compress", "none")
    crcs = manifest.get("crc32")

    def read_one(i: int) -> np.ndarray:
        fn = os.path.join(path, f"{manifest['name']}.shard{i:05d}.npy")
        opener = gzip.open if compress == "gzip" else open
        with opener(fn, "rb") as f:
            raw = f.read()
        if crcs is not None and crcs[i] is not None:
            got = zlib.crc32(raw)
            if got != crcs[i]:
                raise MPIError(
                    ErrorCode.ERR_IO,
                    f"checksum mismatch on {fn}: stored {crcs[i]:#x}, "
                    f"read {got:#x} (corrupt shard)",
                )
        block = np.load(_io.BytesIO(raw))
        _bytes_read.add(block.nbytes)
        return block

    blocks = list(_executor().map(read_one, range(n)))
    if manifest.get("layout", "axis0") == "flat":
        out = np.concatenate([b.reshape(-1) for b in blocks]).reshape(
            manifest["shape"]
        )
    else:
        out = np.stack(blocks, axis=0)
    dtype = manifest["dtype"]
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(out)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(out.astype(dtype)))


def save_pytree(path: str, tree: Any, *, async_: bool = False):
    """Save a pytree of arrays (one sharded entry per leaf, numbered in
    ``jax.tree.flatten``'s order)."""
    os.makedirs(path, exist_ok=True)
    leaves, treedef = pytree.flatten(tree)
    meta = {"treedef": pytree.treedef_str(treedef),
            "num_leaves": len(leaves), "version": 1}
    with open(os.path.join(path, "pytree.json"), "w") as f:
        json.dump(meta, f)
    arrs = [_as_tensor(leaf) for leaf in leaves]
    arrs = [a[None] if a.dim() == 0 else a for a in arrs]
    # an async save copies every leaf before any writer starts: the copies
    # are launched back to back, and the caller may change its state as
    # soon as this returns
    snaps = [_snapshot(a) if async_ else (a, None) for a in arrs]
    futs: List[Future] = []
    for i, (arr, ready) in enumerate(snaps):
        # flat layout: shard count scales with leaf BYTES, not axis 0 —
        # a (32000, d) embed table must not become 32000 row files
        r = _save(path, arr, ready, name=f"leaf{i:04d}", async_=async_,
                  layout="flat", num_shards=None)
        if r:
            futs.extend(r)
    return futs if async_ else None


def load_pytree(path: str, like: Any) -> Any:
    """Load a pytree saved by save_pytree; ``like`` supplies the tree
    structure (and scalar-ness) to restore into: each leaf comes back as
    a tensor on its ``like`` leaf's device, in its dtype."""
    leaves, treedef = pytree.flatten(like)
    out = []
    for i, leaf in enumerate(leaves):
        a = load_sharded(path, name=f"leaf{i:04d}")
        if np.ndim(leaf) == 0 and a.dim() == 1:
            a = a[0]
        if isinstance(leaf, torch.Tensor):
            a = a.to(device=leaf.device, dtype=leaf.dtype)
        elif hasattr(leaf, "dtype"):
            a = a.to(torch_dtype(leaf.dtype))
        out.append(a)
    return pytree.unflatten(treedef, out)
