"""A small PNG codec on the standard library (``zlib`` + ``struct``).

Reads and writes 8-bit greyscale, RGB and RGBA images without interlacing —
what the renderer writes and what the checked-in golden images hold — so
neither writing a frame nor checking a golden needs an imaging package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels, for the 8-bit types this codec handles.
_CHANNELS = {0: 1, 2: 3, 6: 4}
_COLOUR_TYPE = {1: 0, 3: 2, 4: 6}


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def encode(arr: np.ndarray) -> bytes:
    """PNG bytes of a uint8 ``(H, W)``, ``(H, W, 3)`` or ``(H, W, 4)``
    array (filter type 0 on every row)."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError(f"PNG writer takes uint8 pixels, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[2] not in _COLOUR_TYPE:
        raise ValueError(f"PNG writer takes (H, W[, 3|4]) arrays, got "
                         f"{arr.shape}")
    h, w, c = arr.shape
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write(path: str, arr: np.ndarray) -> None:
    """Write a uint8 image array as a PNG file."""
    with open(path, "wb") as f:
        f.write(encode(arr))


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec section 9.2)."""
    out = bytearray(h * stride)
    prior = bytearray(stride)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        line = bytearray(raw[pos + 1:pos + 1 + stride])
        pos += 1 + stride
        if ftype == 1:  # Sub
            for x in range(bpp, stride):
                line[x] = (line[x] + line[x - bpp]) & 0xFF
        elif ftype == 2:  # Up
            for x in range(stride):
                line[x] = (line[x] + prior[x]) & 0xFF
        elif ftype == 3:  # Average
            for x in range(stride):
                left = line[x - bpp] if x >= bpp else 0
                line[x] = (line[x] + ((left + prior[x]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            for x in range(stride):
                a = line[x - bpp] if x >= bpp else 0
                b = prior[x]
                c = prior[x - bpp] if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                if pa <= pb and pa <= pc:
                    pred = a
                elif pb <= pc:
                    pred = b
                else:
                    pred = c
                line[x] = (line[x] + pred) & 0xFF
        elif ftype != 0:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y * stride:(y + 1) * stride] = line
        prior = line
    return np.frombuffer(bytes(out), np.uint8)


def decode(data: bytes) -> np.ndarray:
    """Pixels of a PNG: ``(H, W)`` for greyscale, else ``(H, W, 3|4)``."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {colour}, "
            f"interlace {interlace}): 8-bit grey/RGB/RGBA only")
    c = _CHANNELS[colour]
    pix = _unfilter(zlib.decompress(b"".join(idat)), h, w * c, c)
    return pix.reshape(h, w) if c == 1 else pix.reshape(h, w, c)


def read(path: str) -> np.ndarray:
    """Read a PNG file into a uint8 array."""
    with open(path, "rb") as f:
        return decode(f.read())
