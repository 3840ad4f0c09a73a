"""The two byte formats of a checkpoint, with no package beyond the
standard library: a msgpack subset and zstd frames of raw blocks.

* ``packb`` writes nil, bool, int, float (as float64), str, bytes (bin),
  list/tuple (array) and dict (map) in msgpack's smallest form — the
  bytes ``msgpack.packb(obj, use_bin_type=True)`` gives for such an
  object; ``unpackb`` reads that subset (and float32), with a ``bin`` as
  a ``memoryview`` of the input (no copy).
* ``zstd_frame`` writes a zstd frame (RFC 8878) that stores its content
  in raw blocks of at most 128 KiB, under a header with the
  ``Single_Segment`` flag and the 8-byte ``Frame_Content_Size``, which
  ``zstandard``'s one-shot ``decompress`` needs.  ``zstd_decode`` reads
  raw and RLE blocks itself; a frame with a compressed block (as the
  reference writes at level 3) goes to the ``zstandard`` package,
  imported only then.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple

ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
#: the largest block a frame may hold (RFC 8878, Block_Maximum_Size).
BLOCK_MAX = 128 * 1024


# ---------------------------------------------------------------------------
# msgpack
# ---------------------------------------------------------------------------


def _pack(obj, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        n = len(b)
        if n < 32:
            out.append(bytes((0xa0 | n,)))
        elif n < 1 << 8:
            out.append(b"\xd9" + struct.pack(">B", n))
        elif n < 1 << 16:
            out.append(b"\xda" + struct.pack(">H", n))
        else:
            out.append(b"\xdb" + struct.pack(">I", n))
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = memoryview(obj).nbytes
        if n < 1 << 8:
            out.append(b"\xc4" + struct.pack(">B", n))
        elif n < 1 << 16:
            out.append(b"\xc5" + struct.pack(">H", n))
        else:
            out.append(b"\xc6" + struct.pack(">I", n))
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, b"\xdc", b"\xdd", out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, b"\xde", b"\xdf", out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def _pack_len(n: int, fix: int, b16: bytes, b32: bytes, out) -> None:
    if n < 16:
        out.append(bytes((fix | n,)))
    elif n < 1 << 16:
        out.append(b16 + struct.pack(">H", n))
    else:
        out.append(b32 + struct.pack(">I", n))


def _pack_int(v: int, out: List[bytes]) -> None:
    if 0 <= v < 128:
        out.append(bytes((v,)))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v >= 0:
        for code, fmt, lim in ((b"\xcc", ">B", 1 << 8),
                               (b"\xcd", ">H", 1 << 16),
                               (b"\xce", ">I", 1 << 32),
                               (b"\xcf", ">Q", 1 << 64)):
            if v < lim:
                out.append(code + struct.pack(fmt, v))
                return
        raise OverflowError(f"msgpack: int {v} too large")
    else:
        for code, fmt, lim in ((b"\xd0", ">b", 1 << 7),
                               (b"\xd1", ">h", 1 << 15),
                               (b"\xd2", ">i", 1 << 31),
                               (b"\xd3", ">q", 1 << 63)):
            if v >= -lim:
                out.append(code + struct.pack(fmt, v))
                return
        raise OverflowError(f"msgpack: int {v} too small")


def packb_parts(obj) -> List[bytes]:
    """The pieces of ``packb(obj)`` in order (the large ``bin`` payloads
    as they were given, not copied)."""
    out: List[bytes] = []
    _pack(obj, out)
    return out


def packb(obj) -> bytes:
    return b"".join(packb_parts(obj))


_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
          0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}


def _unpack(buf: memoryview, i: int) -> Tuple[Any, int]:
    c = buf[i]
    i += 1
    if c < 0x80:
        return c, i
    if c >= 0xe0:
        return c - 0x100, i
    if 0xa0 <= c <= 0xbf:
        n = c & 0x1f
        return str(buf[i:i + n], "utf-8"), i + n
    if 0x90 <= c <= 0x9f:
        return _unpack_array(buf, i, c & 0x0f)
    if 0x80 <= c <= 0x8f:
        return _unpack_map(buf, i, c & 0x0f)
    if c == 0xc0:
        return None, i
    if c in (0xc2, 0xc3):
        return c == 0xc3, i
    if c in _FIXED:
        fmt = _FIXED[c]
        return struct.unpack_from(fmt, buf, i)[0], i + struct.calcsize(fmt)
    for codes, fmt in (((0xd9, 0xc4), ">B"), ((0xda, 0xc5), ">H"),
                       ((0xdb, 0xc6), ">I")):
        if c in codes:
            n = struct.unpack_from(fmt, buf, i)[0]
            i += struct.calcsize(fmt)
            data = buf[i:i + n]
            if len(data) != n:
                raise ValueError("msgpack: truncated data")
            return (str(data, "utf-8") if c == codes[0] else data), i + n
    if c in (0xdc, 0xde):
        n = struct.unpack_from(">H", buf, i)[0]
        fn = _unpack_array if c == 0xdc else _unpack_map
        return fn(buf, i + 2, n)
    if c in (0xdd, 0xdf):
        n = struct.unpack_from(">I", buf, i)[0]
        fn = _unpack_array if c == 0xdd else _unpack_map
        return fn(buf, i + 4, n)
    raise ValueError(f"msgpack: unsupported type byte 0x{c:02x}")


def _unpack_array(buf, i: int, n: int):
    out = []
    for _ in range(n):
        v, i = _unpack(buf, i)
        out.append(v)
    return out, i


def _unpack_map(buf, i: int, n: int):
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        v, i = _unpack(buf, i)
        out[k] = v
    return out, i


def unpackb(data) -> Any:
    """One msgpack object from ``data``; trailing bytes raise."""
    buf = memoryview(data).cast("B")
    obj, end = _unpack(buf, 0)
    if end != len(buf):
        raise ValueError("msgpack: extra data after the object")
    return obj


# ---------------------------------------------------------------------------
# zstd frames
# ---------------------------------------------------------------------------


def _zstandard():
    """The ``zstandard`` module, for frames with compressed blocks; its
    absence raises naming the package, as the reference's ``_zstd``."""
    try:
        import zstandard
    except ModuleNotFoundError:
        raise ModuleNotFoundError(
            "this checkpoint holds zstd-compressed blocks, which need the "
            "optional 'zstandard' package (pip install zstandard); "
            "checkpoints written by repro_torch need no package") from None
    return zstandard


def zstd_frame(data) -> bytes:
    """A zstd frame of ``data`` in raw blocks."""
    mv = memoryview(data).cast("B")
    n = len(mv)
    # Frame_Header_Descriptor: FCS_flag 3 (8 bytes), Single_Segment 1.
    parts = [ZSTD_MAGIC + b"\xe0" + struct.pack("<Q", n)]
    for s in (range(0, n, BLOCK_MAX) if n else [0]):
        size = min(BLOCK_MAX, n - s)
        last = s + size >= n
        parts.append(struct.pack("<I", (size << 3) | int(last))[:3])
        parts.append(mv[s:s + size])
    return b"".join(parts)


def zstd_decode(frame) -> bytes:
    """The content of one zstd frame."""
    mv = memoryview(frame).cast("B")
    if bytes(mv[:4]) != ZSTD_MAGIC:
        raise ValueError("zstd: not a zstd frame")
    fhd = mv[4]
    fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
    checksum, dict_flag = (fhd >> 2) & 1, fhd & 3
    i = 5 + (0 if single else 1) + (0, 1, 2, 4)[dict_flag]
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content = None
    if fcs_size:
        content = int.from_bytes(mv[i:i + fcs_size], "little") + \
            (256 if fcs_size == 2 else 0)
    i += fcs_size
    parts = []
    while True:
        if i + 3 > len(mv):
            raise ValueError("zstd: truncated frame")
        head = int.from_bytes(mv[i:i + 3], "little")
        i += 3
        last, btype, size = head & 1, (head >> 1) & 3, head >> 3
        if btype == 0:
            if i + size > len(mv):
                raise ValueError("zstd: truncated raw block")
            parts.append(mv[i:i + size])
            i += size
        elif btype == 1:
            parts.append(bytes(mv[i:i + 1]) * size)
            i += 1
        elif btype == 2:
            return _zstandard().ZstdDecompressor().decompress(bytes(mv))
        else:
            raise ValueError("zstd: reserved block type")
        if last:
            break
    i += 4 * checksum
    out = b"".join(parts)
    if content is not None and len(out) != content:
        raise ValueError(f"zstd: {len(out)} bytes, the header says "
                         f"{content}")
    return out
