"""Image save/load — the screenshot path.

Replaces the reference's glGetTexImage + stb PNG screenshot flow
(/root/reference/apps/gsrast/Inspector.cpp:222-267): rendered arrays go
straight to timestamped PNGs. The flip-Y the reference needs (GL origin) does
not apply — our images are already row-0-top.

PNG is written and read by a small stdlib codec (zlib + struct): 8-bit
RGB/RGBA (and grayscale on read), non-interlaced, all five row filters.
"""

from __future__ import annotations

import datetime
import os
import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples per pixel


def to_uint8(img) -> np.ndarray:
    arr = np.asarray(img)
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def encode_png(arr: np.ndarray) -> bytes:
    """(H, W, 3|4) uint8 -> PNG bytes (filter 0 on every row)."""
    h, w, c = arr.shape
    ctype = {3: 2, 4: 6}[c]
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, channels) uint8. 8-bit, non-interlaced only."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace or ctype not in _CHANNELS:
        raise ValueError(f"unsupported PNG: depth={depth} colour={ctype} "
                         f"interlace={interlace}")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * bpp)
    out = np.zeros((h, w * bpp), np.int32)
    prev = np.zeros(w * bpp, np.int32)
    for y in range(h):
        ftype, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:
            cur = np.cumsum(line.reshape(w, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        else:  # filters 3, 4 depend on the reconstructed left pixel
            cur = np.zeros_like(line)
            for x in range(0, w * bpp, bpp):
                left = cur[x - bpp:x] if x else np.zeros(bpp, np.int32)
                up = prev[x:x + bpp]
                if ftype == 3:
                    pred = (left + up) >> 1
                elif ftype == 4:
                    upleft = prev[x - bpp:x] if x else np.zeros(bpp, np.int32)
                    pred = _paeth(left, up, upleft)
                else:
                    raise ValueError(f"bad PNG filter {ftype}")
                cur[x:x + bpp] = (line[x:x + bpp] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out.astype(np.uint8).reshape(h, w, bpp)


def save_png(img, path: str) -> str:
    arr = to_uint8(img)
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(arr))
    return path


def load_png(path: str) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1]; alpha dropped, grey expanded."""
    with open(path, "rb") as f:
        arr = decode_png(f.read())
    if arr.shape[2] in (1, 2):
        arr = np.repeat(arr[:, :, :1], 3, axis=2)
    return arr[:, :, :3].astype(np.float32) / 255.0


def screenshot(img, directory: str = ".", prefix: str = "screenshot") -> str:
    """Timestamped capture, like the Inspector's screenshot button
    (Inspector.cpp:236-248 formats a time-based filename)."""
    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    return save_png(img, os.path.join(directory, f"{prefix}_{stamp}.png"))
