"""The datatype engine of the PyTorch port held against the JAX package.

Every case of ``tests/test_datatype.py`` runs here through both
packages on the same inputs: the index maps, the packed payloads, the
unpacked buffers, the external32 bytes and the checksums must be
BITWISE equal (pack/unpack move elements and never compute, and the
checksum is an exact integer sum). Also: ``unpack`` leaves the caller's
buffer unchanged, ``BFLOAT16`` is ``torch.bfloat16`` with no fallback,
and ``DOUBLE`` stays 8 bytes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ompi_release_tpu import datatype as jdt
from ompi_release_tpu.datatype import Convertor as JConvertor
from ompi_release_tpu_torch import datatype as tdt
from ompi_release_tpu_torch.datatype import Convertor as TConvertor
from ompi_release_tpu_torch.utils.errors import ErrorCode, MPIError


def _both(name):
    return getattr(jdt, name), getattr(tdt, name)


def _same(jout, tout):
    """Bitwise equality of a JAX array and a torch tensor."""
    j = np.asarray(jout)
    if tout.dtype is torch.bfloat16:
        tout = tout.view(torch.int16)
    t = tout.detach().cpu().numpy()
    assert j.shape == t.shape, (j.shape, t.shape)
    assert j.dtype.itemsize == t.dtype.itemsize
    uint = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[
        j.dtype.itemsize]
    np.testing.assert_array_equal(j.view(uint), t.view(uint))


def _buf(n, seed=0):
    """The same f32 buffer in both packages (random, so a moved element
    shows in its bits)."""
    a = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _types(make):
    """``make(module)`` for both packages: (jax type, torch type)."""
    return make(jdt), make(tdt)


def _offsets_equal(jt, tt, n_items=1):
    np.testing.assert_array_equal(jt.offsets(n_items), tt.offsets(n_items))
    assert jt.count == tt.count and jt.get_extent() == tt.get_extent()


def test_predefined_sizes():
    for name in tdt.PREDEFINED:
        j, t = jdt.PREDEFINED[name], tdt.PREDEFINED[name]
        if name == "bfloat16":
            continue  # the reference may fall back to f16; sizes agree
        assert j.size_bytes == t.size_bytes, name
    assert tdt.FLOAT.size_bytes == 4
    assert tdt.INT64.size_bytes == 8
    assert tdt.BFLOAT16.size_bytes == 2
    assert tdt.FLOAT.is_contiguous


def test_bfloat16_is_torch_bfloat16_no_fallback():
    assert tdt.BFLOAT16.base_dtype is torch.bfloat16
    assert tdt.DOUBLE.base_dtype is torch.float64
    assert tdt.DOUBLE.size_bytes == 8  # 8 bytes on the wire
    assert tdt.from_torch_dtype(torch.float64) is tdt.DOUBLE


def test_contiguous():
    jt, tt = _types(lambda m: m.create_contiguous(5, m.FLOAT))
    assert tt.count == 5 and tt.is_contiguous
    jb, tb = _buf(10)
    _same(JConvertor(jt, count=2).pack(jb), TConvertor(tt, count=2).pack(tb))


def test_vector_pack_unpack():
    jt, tt = _types(lambda m: m.create_vector(3, 2, 4, m.FLOAT))
    assert list(tt.offsets()) == [0, 1, 4, 5, 8, 9]
    jb, tb = _buf(12)
    jc, tc = JConvertor(jt), TConvertor(tt)
    jp, tp = jc.pack(jb), tc.pack(tb)
    _same(jp, tp)
    _same(jc.unpack(jp * 10, jnp.zeros(12, jnp.float32)),
          tc.unpack(tp * 10, torch.zeros(12)))


def test_vector_multi_item_extent():
    jt, tt = _types(lambda m: m.create_vector(2, 1, 3, m.FLOAT))
    assert tt.get_extent() == 4
    _offsets_equal(jt, tt, 2)
    assert list(TConvertor(tt, count=2).dtype.offsets(2)) == [0, 3, 4, 7]


def test_resized_extent():
    jt, tt = _types(lambda m: m.create_vector(2, 1, 3, m.FLOAT).resized(8))
    assert tt.get_extent() == 8
    _offsets_equal(jt, tt, 2)
    assert list(tt.offsets(2)) == [0, 3, 8, 11]


def test_hindexed():
    jt, tt = _types(lambda m: m.create_hindexed([2, 3], [1, 6], m.FLOAT))
    assert list(tt.offsets()) == [1, 2, 6, 7, 8]
    jb, tb = _buf(10)
    _same(JConvertor(jt).pack(jb), TConvertor(tt).pack(tb))


def test_indexed_block():
    jt, tt = _types(lambda m: m.create_indexed_block(2, [0, 4], m.FLOAT))
    _offsets_equal(jt, tt)
    assert list(tt.offsets()) == [0, 1, 4, 5]


def test_struct_homogeneous():
    jt, tt = _types(lambda m: m.create_struct([1, 2], [0, 3],
                                              [m.FLOAT, m.FLOAT]))
    _offsets_equal(jt, tt)
    assert list(tt.offsets()) == [0, 3, 4]


def test_struct_heterogeneous_rejected():
    with pytest.raises(ValueError):
        jdt.create_struct([1, 1], [0, 1], [jdt.FLOAT, jdt.INT32])
    with pytest.raises(ValueError):
        tdt.create_struct([1, 1], [0, 1], [tdt.FLOAT, tdt.INT32])


def test_subarray():
    jt, tt = _types(lambda m: m.create_subarray([4, 4], [2, 2], [1, 1],
                                                m.FLOAT))
    assert list(tt.offsets()) == [5, 6, 9, 10]
    _offsets_equal(jt, tt)
    jb, tb = _buf(16)
    _same(JConvertor(jt).pack(jb), TConvertor(tt).pack(tb))


def test_partial_pack_roundtrip():
    """Segmented pack/unpack: the pipelined-protocol path."""
    jt, tt = _types(lambda m: m.create_vector(4, 2, 3, m.FLOAT))
    jb, tb = _buf(12)
    jc, tc = JConvertor(jt), TConvertor(tt)
    jpos = tpos = 0
    jsegs, tsegs = [], []
    while tpos < tc.packed_elements:
        jseg, jpos = jc.pack_partial(jb, jpos, 3)
        tseg, tpos = tc.pack_partial(tb, tpos, 3)
        assert jpos == tpos
        _same(jseg, tseg)
        jsegs.append(jseg)
        tsegs.append(tseg)
    _same(jc.pack(jb), torch.cat(tsegs))
    jout, tout = jnp.zeros(12, jnp.float32), torch.zeros(12)
    jpos = tpos = 0
    for jseg, tseg in zip(jsegs, tsegs):
        jout, jpos = jc.unpack_partial(jseg, jout, jpos)
        tout, tpos = tc.unpack_partial(tseg, tout, tpos)
        assert jpos == tpos
    _same(jout, tout)
    _same(jc.pack(jout), tc.pack(tout))


def test_to_self_roundtrip():
    """Self-send loopback of a struct type (test/datatype/to_self.c)."""
    jt, tt = _types(lambda m: m.create_struct([2, 1], [0, 5],
                                              [m.FLOAT, m.FLOAT]))
    jb, tb = _buf(8)
    jc, tc = JConvertor(jt), TConvertor(tt)
    jrecv = jc.unpack(jc.pack(jb), jnp.zeros(8, jnp.float32))
    trecv = tc.unpack(tc.pack(tb), torch.zeros(8))
    _same(jrecv, trecv)
    for off in tt.offsets():
        assert trecv[int(off)] == tb[int(off)]


def test_checksum_detects_corruption():
    jb, tb = _buf(64)
    c1 = TConvertor.checksum(tb)
    assert int(c1) == int(JConvertor.checksum(jb))
    corrupted = tb.clone()
    corrupted[13] = 999.0
    assert int(TConvertor.checksum(corrupted)) != int(c1)
    assert int(TConvertor.checksum(corrupted)) == int(
        JConvertor.checksum(jb.at[13].set(999.0)))
    # position-dependence: swapping two elements changes the sum
    swapped = tb.clone()
    swapped[0], swapped[1] = tb[1], tb[0]
    assert int(TConvertor.checksum(swapped)) != int(c1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "uint8"])
def test_checksum_equals_jax(dtype):
    """The wrapping uint32 sum equals JAX's for the same bytes, past the
    first 2^32 wrap (every byte 255 over 2^16 bytes reaches 2^33) and
    across more than one checksum chunk."""
    rng = np.random.default_rng(5)
    n = (1 << 16) + 3
    if dtype in ("int8", "uint8"):
        a = rng.integers(0, 256, size=4 * n).astype(np.uint8).view(dtype)
        a[: 1 << 16] = np.array(255, np.uint8).view(dtype)
        j, t = jnp.asarray(a), torch.from_numpy(a.copy())
    else:
        a = rng.normal(size=n).astype(np.float32)
        j = jnp.asarray(a).astype(dtype)
        t = torch.from_numpy(a.copy()).to(getattr(torch, dtype))
    want = int(JConvertor.checksum(j))
    assert int(TConvertor.checksum(t)) == want
    from ompi_release_tpu_torch.datatype import convertor as tcv

    saved = tcv._CHECKSUM_CHUNK
    tcv._CHECKSUM_CHUNK = 4096  # many chunks: the same value
    try:
        assert int(TConvertor.checksum(t)) == want
    finally:
        tcv._CHECKSUM_CHUNK = saved


def test_from_torch_dtype():
    """The counterpart of ``from_jax_dtype``: every predefined type maps
    back from its dtype (torch or numpy) exactly as JAX's does."""
    assert tdt.from_torch_dtype(torch.float32) is tdt.FLOAT
    assert tdt.from_torch_dtype(torch.bfloat16) is tdt.BFLOAT16
    assert tdt.from_torch_dtype(np.int32) is tdt.INT32
    assert jdt.from_jax_dtype(jnp.float32) is jdt.FLOAT
    for np_dtype in (np.float32, np.float64, np.int8, np.int16, np.int32,
                     np.int64, np.uint8, np.uint16, np.uint32, np.uint64,
                     np.bool_, np.complex64):
        assert tdt.from_torch_dtype(np_dtype).name == \
            jdt.from_jax_dtype(np_dtype).name, np_dtype
    with pytest.raises(ValueError):
        tdt.from_torch_dtype(torch.float16)


def test_struct_mismatched_lengths_rejected():
    for m in (jdt, tdt):
        with pytest.raises(ValueError):
            m.create_struct([1, 2, 3], [0, 3], [m.FLOAT, m.FLOAT])


def test_partial_pack_truncate_guard():
    tt = tdt.create_vector(4, 1, 4, tdt.FLOAT)  # spans 13
    tc = TConvertor(tt)
    small = torch.arange(8, dtype=torch.float32)
    with pytest.raises(MPIError) as e:
        tc.pack_partial(small, 0, 2)
    assert e.value.code == ErrorCode.ERR_TRUNCATE
    with pytest.raises(MPIError):
        tc.unpack_partial(torch.zeros(2), small, 0)
    jc = JConvertor(jdt.create_vector(4, 1, 4, jdt.FLOAT))
    with pytest.raises(Exception):
        jc.pack_partial(jnp.arange(8, dtype=jnp.float32), 0, 2)


def test_unpack_leaves_callers_buffer_unchanged():
    """The reference is functional (``flat.at[...].set``); torch tensors
    are mutable, so unpack writes a copy: the caller's buffer keeps its
    bits, for the full, partial and external32 paths."""
    tt = tdt.create_vector(3, 2, 4, tdt.FLOAT)
    tc = TConvertor(tt)
    _, tb = _buf(12)
    before = tb.clone()
    payload = torch.full((6,), 7.0)
    out = tc.unpack(payload, tb)
    assert torch.equal(tb, before) and out.data_ptr() != tb.data_ptr()
    tc.unpack_partial(payload[:3], tb, 0)
    tc.unpack_external(tc.pack_external(payload.repeat(2)), tb)
    assert torch.equal(tb, before)
    # identity map too (the slice path)
    tci = TConvertor(tdt.create_contiguous(4, tdt.FLOAT))
    tci.unpack(torch.ones(4), tb)
    assert torch.equal(tb, before)


class TestDarray:
    """MPI_Type_create_darray: block/cyclic HPF-style decomposition."""

    def test_block_block_2d(self):
        seen = np.zeros(24, np.int32)
        for r in range(4):
            jt, tt = _types(lambda m: m.create_darray(
                4, r, [4, 6], [m.DIST_BLOCK, m.DIST_BLOCK],
                [m.DARG_DEFAULT, m.DARG_DEFAULT], [2, 2], m.FLOAT))
            _offsets_equal(jt, tt)
            offs = tt.offsets(1)
            seen[offs] += 1
            if r == 0:
                np.testing.assert_array_equal(offs, [0, 1, 2, 6, 7, 8])
        np.testing.assert_array_equal(seen, np.ones(24))  # exact cover

    def test_cyclic_1d(self):
        jt, tt = _types(lambda m: m.create_darray(
            3, 1, [10], [m.DIST_CYCLIC], [m.DARG_DEFAULT], [3], m.FLOAT))
        _offsets_equal(jt, tt)
        np.testing.assert_array_equal(tt.offsets(1), [1, 4, 7])
        jt, tt = _types(lambda m: m.create_darray(
            2, 0, [10], [m.DIST_CYCLIC], [2], [2], m.FLOAT))
        _offsets_equal(jt, tt)
        np.testing.assert_array_equal(tt.offsets(1), [0, 1, 4, 5, 8, 9])

    def test_block_cyclic_2d_pack_roundtrip(self):
        """A BLOCK x CYCLIC(4) grid of 2 x 4 over a (16, 64) array: each
        rank's pack equals JAX's and plain indexing; unpacking all eight
        into zeros rebuilds the array bitwise."""
        jb, tb = _buf(16 * 64, seed=3)
        tout = torch.zeros(16 * 64)
        for r in range(8):
            jt, tt = _types(lambda m: m.create_darray(
                8, r, [16, 64], [m.DIST_BLOCK, m.DIST_CYCLIC],
                [m.DARG_DEFAULT, 4], [2, 4], m.FLOAT))
            tp = TConvertor(tt).pack(tb)
            _same(JConvertor(jt).pack(jb), tp)
            assert torch.equal(tp, tb[torch.from_numpy(
                tt.offsets(1).astype(np.int64))])
            tout = TConvertor(tt).unpack(tp, tout)
        assert torch.equal(tout, tb)

    def test_validation(self):
        for m in (jdt, tdt):
            with pytest.raises(Exception):
                m.create_darray(4, 0, [8], [m.DIST_BLOCK], [1], [4],
                                m.FLOAT)  # 1*4 < 8
            with pytest.raises(Exception):
                m.create_darray(2, 0, [8], [m.DIST_NONE],
                                [m.DARG_DEFAULT], [2], m.FLOAT)
            with pytest.raises(Exception):
                m.create_darray(4, 5, [8], [m.DIST_BLOCK],
                                [m.DARG_DEFAULT], [4], m.FLOAT)

    def test_cyclic_bad_darg_rejected(self):
        for m in (jdt, tdt):
            for bad in (0, -2):
                with pytest.raises(Exception):
                    m.create_darray(2, 0, [10], [m.DIST_CYCLIC], [bad], [2],
                                    m.FLOAT)


def test_pack_external_big_endian_roundtrip():
    """MPI_Pack_external ("external32"): canonical BIG-endian bytes,
    the same stream as JAX's, through a strided datatype; the DATATYPE
    sets the wire width (DOUBLE: 8 bytes); a truncated stream is a loud
    error."""
    jt, tt = _types(lambda m: m.create_vector(3, 2, 4, m.FLOAT))
    jc, tc = JConvertor(jt), TConvertor(tt)
    jb = jnp.arange(12, dtype=jnp.float32)
    tb = torch.arange(12, dtype=torch.float32)
    raw = tc.pack_external(tb)
    assert raw.dtype == np.uint8 and raw.size == tc.packed_bytes
    np.testing.assert_array_equal(raw, jc.pack_external(jb))
    np.testing.assert_array_equal(
        raw[4:8], np.frombuffer(np.array(1.0, ">f4").tobytes(), np.uint8))
    _same(jc.unpack_external(raw, jnp.zeros(12, jnp.float32)),
          tc.unpack_external(raw, torch.zeros(12)))
    _same(jc.unpack_external(raw.tobytes(), jnp.zeros(12, jnp.float32)),
          tc.unpack_external(raw.tobytes(), torch.zeros(12)))
    j8, t8 = _types(lambda m: m.create_vector(3, 2, 4, m.DOUBLE))
    raw8 = TConvertor(t8).pack_external(tb)
    assert raw8.size == TConvertor(t8).packed_bytes == 6 * 8
    np.testing.assert_array_equal(raw8, JConvertor(j8).pack_external(jb))
    _same(JConvertor(j8).unpack_external(raw8, jnp.zeros(12, jnp.float32)),
          TConvertor(t8).unpack_external(raw8, torch.zeros(12)))
    with pytest.raises(MPIError, match="external32"):
        tc.unpack_external(raw[:-1], torch.zeros(12))


def test_pack_external_bfloat16():
    """A bf16 payload (no numpy dtype) byteswaps through its int16 bits:
    the same big-endian stream as JAX's, and it round-trips bitwise."""
    jt, tt = _types(lambda m: m.create_vector(4, 3, 5, m.BFLOAT16))
    a = np.random.default_rng(9).normal(size=20).astype(np.float32)
    jb = jnp.asarray(a).astype(jnp.bfloat16)
    tb = torch.from_numpy(a).to(torch.bfloat16)
    raw = TConvertor(tt).pack_external(tb)
    np.testing.assert_array_equal(raw, JConvertor(jt).pack_external(jb))
    back = TConvertor(tt).unpack_external(raw, torch.zeros(20,
                                                          dtype=torch.bfloat16))
    _same(JConvertor(jt).unpack_external(raw, jnp.zeros(20, jnp.bfloat16)),
          back)


@pytest.mark.parametrize("dtype", [torch.uint16, torch.uint32, torch.uint64,
                                   torch.bool, torch.int8])
def test_pack_unpack_other_dtypes(dtype):
    """Element types torch indexes only through a same-width integer
    view (uint16/32/64) pack and unpack bitwise like the rest."""
    tt = tdt.create_vector(3, 2, 4, tdt.from_torch_dtype(dtype))
    tc = TConvertor(tt)
    src = torch.arange(12).to(dtype) if dtype is not torch.bool else \
        torch.arange(12) % 3 == 0
    p = tc.pack(src)
    assert p.dtype == dtype
    want = src[torch.tensor([0, 1, 4, 5, 8, 9])]
    assert torch.equal(p.to(torch.int64), want.to(torch.int64))
    out = tc.unpack(p, torch.zeros(12, dtype=dtype))
    assert torch.equal(tc.pack(out).to(torch.int64), want.to(torch.int64))


def test_device_offsets_cached_once():
    tt = tdt.create_vector(3, 2, 4, tdt.FLOAT)
    a = tt.device_offsets(1, "cpu")
    assert a is tt.device_offsets(1, "cpu")
    assert a.dtype == torch.int32
    assert tt.dup().device_offsets(1, "cpu") is a  # same map, same copy
    assert tt.resized(20).device_offsets(2, "cpu") is not \
        tt.device_offsets(2, "cpu")
