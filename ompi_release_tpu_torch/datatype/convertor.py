"""Pack/unpack convertors: the ``opal_convertor`` analogue on torch
tensors (counterpart of ``ompi_release_tpu/datatype/convertor.py``).

The reference walks byte state machines supporting partial buffers and
checksums (``opal/datatype/opal_convertor.c:707``,
``opal_datatype_pack.c``). Here pack is one ``index_select`` (a slice
for the identity map) and unpack one indexed store into a COPY of the
buffer: the caller's tensor is never written. Partial (segmented)
pack/unpack for pipelined protocols slices the index map.

``checksum`` (``opal_datatype_checksum.h`` analogue) is a position-
weighted byte sum that wraps at 2^32, computed on the payload's device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..mca import pvar
from ..utils.errors import ErrorCode, MPIError
from .datatype import Datatype

_pack_count = pvar.counter(
    "datatype_pack_count", "number of convertor pack operations"
)
_unpack_count = pvar.counter(
    "datatype_unpack_count", "number of convertor unpack operations"
)

#: dtypes whose indexing kernels torch lacks: moved as same-width ints
_BITS = {torch.uint16: torch.int16, torch.uint32: torch.int32,
         torch.uint64: torch.int64}
#: bytes per chunk of the on-device checksum (int64 temporaries)
_CHECKSUM_CHUNK = 1 << 24


def _bits(t: torch.Tensor) -> torch.Tensor:
    alias = _BITS.get(t.dtype)
    return t if alias is None else t.view(alias)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy; bf16 (no numpy dtype) as its int16 bits."""
    t = t.detach().cpu()
    if t.dtype is torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


class Convertor:
    """Packs/unpacks ``count`` items of ``dtype`` against a flat buffer:
    a tensor in element units of the datatype's base dtype, on any
    device (the index map follows it there)."""

    def __init__(self, dtype: Datatype, count: int = 1) -> None:
        self.dtype = dtype
        self.count = count
        # identity map when items are contiguous and (for count>1)
        # back-to-back; only then can pack be a plain slice
        back_to_back = count == 1 or dtype.get_extent() == dtype.span
        self._offsets: Optional[np.ndarray] = (
            None if dtype.is_contiguous and back_to_back
            else dtype.offsets(count)
        )
        # the span check runs per call: its bound is computed once
        self._span = (self.packed_elements if self._offsets is None
                      else int(self._offsets.max()) + 1
                      if len(self._offsets) else 0)

    # -- totals ------------------------------------------------------------
    @property
    def packed_elements(self) -> int:
        return self.dtype.count * self.count

    @property
    def packed_bytes(self) -> int:
        return self.packed_elements * self.dtype.base_dtype.itemsize

    def required_span(self) -> int:
        """Minimum origin-buffer length in elements."""
        return self._span

    def _check_span(self, flat: torch.Tensor) -> None:
        """Raise ERR_TRUNCATE if the origin buffer can't hold the type
        (MPI_ERR_TRUNCATE, instead of an out-of-bounds index)."""
        need = self.required_span()
        if flat.shape[0] < need:
            raise MPIError(
                ErrorCode.ERR_TRUNCATE,
                f"buffer has {flat.shape[0]} elements but datatype "
                f"{self.dtype.name!r} x{self.count} spans {need}",
            )

    def _index(self, device, lo: int = 0,
               hi: Optional[int] = None) -> torch.Tensor:
        idx = self.dtype.device_offsets(self.count, device)
        return idx if (lo == 0 and hi is None) else idx[lo:hi]

    def _gather(self, flat: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        if self._offsets is None:
            return flat[lo:hi].clone()
        src = _bits(flat)
        out = src.index_select(0, self._index(flat.device, lo, hi))
        return out.view(flat.dtype) if src is not flat else out

    def _scatter(self, payload: torch.Tensor, buffer: torch.Tensor,
                 lo: int, hi: int) -> torch.Tensor:
        flat = buffer.reshape(-1)
        payload = payload.reshape(-1).to(device=flat.device,
                                         dtype=flat.dtype)
        out = flat.clone()  # never the caller's storage
        if self._offsets is None:
            out[lo:hi] = payload
        else:
            _bits(out)[self._index(out.device, lo, hi)] = _bits(payload)
        return out.reshape(buffer.shape)

    # -- full pack/unpack --------------------------------------------------
    def pack(self, buffer: torch.Tensor) -> torch.Tensor:
        """Gather the described elements into a dense 1-D payload."""
        _pack_count.add()
        flat = buffer.reshape(-1)
        self._check_span(flat)
        return self._gather(flat, 0, self.packed_elements)

    def unpack(self, payload: torch.Tensor,
               buffer: torch.Tensor) -> torch.Tensor:
        """Scatter a dense payload into a copy of ``buffer``."""
        _unpack_count.add()
        self._check_span(buffer.reshape(-1))
        return self._scatter(payload, buffer, 0, self.packed_elements)

    # -- external32 (MPI_Pack_external, "external32" representation) -------
    def pack_external(self, buffer: torch.Tensor) -> np.ndarray:
        """MPI_Pack_external: the canonical BIG-ENDIAN byte stream of
        the described elements (``ompi/mpi/c/pack_external.c``). The
        wire element type is the DATATYPE's base dtype (a float32
        buffer through a DOUBLE datatype goes out as 8-byte floats).
        A serialization API, not a hot path: it runs at the host edge
        and returns uint8 bytes."""
        payload = _to_numpy(self.pack(buffer).to(self.dtype.base_dtype))
        be = payload.astype(payload.dtype.newbyteorder(">"), copy=False)
        return np.frombuffer(be.tobytes(), dtype=np.uint8)

    def unpack_external(self, raw, buffer: torch.Tensor) -> torch.Tensor:
        """MPI_Unpack_external: decode a big-endian external32 stream
        (bytes, bytearray, or a uint8 array) into a copy of
        ``buffer``."""
        want = self.packed_bytes
        if isinstance(raw, (bytes, bytearray, memoryview)):
            raw = np.frombuffer(raw, dtype=np.uint8)
        else:
            raw = np.asarray(raw, dtype=np.uint8).reshape(-1)
        if raw.size != want:
            raise MPIError(
                ErrorCode.ERR_TRUNCATE,
                f"external32 stream is {raw.size} B, datatype "
                f"describes {want} B",
            )
        wire = self.dtype.base_dtype
        host = _to_numpy(torch.empty(0, dtype=wire)).dtype
        native = np.frombuffer(raw.tobytes(),
                               dtype=host.newbyteorder(">")).astype(host)
        payload = torch.from_numpy(native)
        if wire is torch.bfloat16:
            payload = payload.view(torch.bfloat16)
        return self.unpack(payload, buffer)

    # -- partial (segmented) ----------------------------------------------
    def pack_partial(self, buffer: torch.Tensor, position: int,
                     max_elements: int) -> Tuple[torch.Tensor, int]:
        """Pack up to ``max_elements`` packed elements starting at
        ``position`` (the ``opal_convertor_set_position`` analogue used
        by pipelined/segmented protocols). Returns (payload, new_pos)."""
        end = min(position + max_elements, self.packed_elements)
        flat = buffer.reshape(-1)
        self._check_span(flat)
        seg = self._gather(flat, position, end)
        _pack_count.add()
        return seg, end

    def unpack_partial(self, payload: torch.Tensor, buffer: torch.Tensor,
                       position: int) -> Tuple[torch.Tensor, int]:
        self._check_span(buffer.reshape(-1))
        end = position + payload.reshape(-1).shape[0]
        out = self._scatter(payload, buffer, position, end)
        _unpack_count.add()
        return out, end

    # -- checksum ----------------------------------------------------------
    @staticmethod
    def checksum(payload: torch.Tensor) -> torch.Tensor:
        """Position-weighted byte sum ``sum_i b_i * (i % 251 + 1)`` mod
        2^32 over the payload's bytes (host byte order), on the
        payload's device: a 0-d int64 tensor holding the uint32 value.
        Reference: ``opal/datatype/opal_datatype_checksum.h``. Torch
        has little uint32 arithmetic on CUDA, so each chunk of
        ``_CHECKSUM_CHUNK`` bytes is summed exactly in int64 (below
        255 * 251 * 2^24 < 2^63) and the total masked to 32 bits."""
        b = payload.detach().contiguous().reshape(-1).view(torch.uint8)
        total = torch.zeros((), dtype=torch.int64, device=b.device)
        for lo in range(0, b.numel(), _CHECKSUM_CHUNK):
            part = b[lo:lo + _CHECKSUM_CHUNK].to(torch.int64)
            w = torch.arange(lo, lo + part.numel(), dtype=torch.int64,
                             device=b.device) % 251 + 1
            total = (total + (part * w).sum()) & 0xFFFFFFFF
        return total
