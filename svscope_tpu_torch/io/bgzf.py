"""BGZF (blocked gzip) reader/writer.

BAM files are BGZF streams: concatenated gzip members, each with a BC extra
subfield carrying the compressed block size (BSIZE).  The reference relied on
htslib via pysam (src/DataScanner.py:77) and external `bgzip`/`tabix`
binaries (src/SVscope.py:59); here we implement the container natively so the
framework has no subprocess or pysam dependency.  A C++ fast path can drop in
behind the same API (see native/).
"""
from __future__ import annotations

import struct
import zlib

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def read_blocks(data: bytes):
    """Yield decompressed blocks from a BGZF byte string."""
    pos = 0
    n = len(data)
    while pos < n:
        if data[pos:pos + 2] != b"\x1f\x8b":
            raise ValueError(f"bad gzip magic at offset {pos}")
        xlen = struct.unpack_from("<H", data, pos + 10)[0]
        extra = data[pos + 12: pos + 12 + xlen]
        bsize = None
        epos = 0
        while epos + 4 <= len(extra):
            si1, si2, slen = extra[epos], extra[epos + 1], struct.unpack_from("<H", extra, epos + 2)[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = struct.unpack_from("<H", extra, epos + 4)[0] + 1
                break
            epos += 4 + slen
        if bsize is None:
            raise ValueError("gzip member without BGZF BC subfield")
        cdata = data[pos + 12 + xlen: pos + bsize - 8]
        block = zlib.decompress(cdata, -15)
        yield block
        pos += bsize


def decompress(data: bytes) -> bytes:
    return b"".join(read_blocks(data))


def decompress_file(path: str) -> bytes:
    with open(path, "rb") as f:
        return decompress(f.read())


def compress_block(block: bytes, level: int = 6) -> bytes:
    """Compress one <=64KiB payload into a BGZF member."""
    if len(block) > 65536:
        raise ValueError("BGZF block payload must be <= 64KiB")
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = co.compress(block) + co.flush()
    crc = zlib.crc32(block) & 0xFFFFFFFF
    bsize = len(cdata) + 26  # 12B header + 6B BC subfield + cdata + 8B tail
    # header: ID1 ID2 CM FLG MTIME XFL OS XLEN
    header = struct.pack("<2B2BIBBH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6)
    subfield = struct.pack("<2BHH", 66, 67, 2, bsize - 1)
    tail = struct.pack("<II", crc, len(block))
    return header + subfield + cdata + tail


def compress(data: bytes, level: int = 6, block_size: int = 65280) -> bytes:
    """Compress bytes into a BGZF stream (with EOF marker)."""
    out = []
    for off in range(0, len(data), block_size):
        out.append(compress_block(data[off:off + block_size], level))
    out.append(_BGZF_EOF)
    return b"".join(out)


def compress_to_file(path: str, data: bytes, level: int = 6) -> None:
    with open(path, "wb") as f:
        f.write(compress(data, level))
