"""PNG decode and encode with the standard library's `zlib` and NumPy.

The decode path of `KittiDataset` where the native loader
(legoslam_tpu_torch/native) cannot be built, and the writer that makes
KITTI-format sequences on machines without an imaging library.  Decoding
gives what the native loader gives, byte for byte: grayscale uint8, with
colour converted by libpng's `png_set_rgb_to_gray_fixed(png, 1, 29900,
58700)` arithmetic (the ITU-R BT.601 weights the reference's cv::imread
grayscale path uses), 16-bit samples cut to their high byte, alpha dropped,
1/2/4-bit gray scaled to 8 bits and palettes expanded.  Interlaced files
are refused (None), as the native loader refuses them.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# png_set_rgb_to_gray_fixed(png, 1, 29900, 58700): 15-bit weights (pngrtran.c)
RED_W = 29900 * 32768 // 100000
GREEN_W = 58700 * 32768 // 100000
BLUE_W = 32768 - RED_W - GREEN_W


def _paeth_row(raw: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    out = [0] * len(raw)
    r, p = raw.tolist(), prior.tolist()
    for i in range(len(r)):
        a = out[i - bpp] if i >= bpp else 0
        b = p[i]
        c = p[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (r[i] + pred) & 0xFF
    return np.asarray(out, np.uint8)


def _average_row(raw: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    out = [0] * len(raw)
    r, p = raw.tolist(), prior.tolist()
    for i in range(len(r)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (r[i] + ((a + p[i]) >> 1)) & 0xFF
    return np.asarray(out, np.uint8)


def unfilter(data: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters: (height, stride) uint8."""
    rows = np.frombuffer(data, np.uint8)[: height * (stride + 1)].reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, raw = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = raw.copy()
        elif ftype == 1:     # Sub: a running sum per byte lane of a pixel
            pad = (-stride) % bpp
            lanes = np.concatenate([raw, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            cur = np.cumsum(lanes, axis=0, dtype=np.uint8).reshape(-1)[:stride]
        elif ftype == 2:     # Up
            cur = raw + prior
        elif ftype == 3:     # Average
            cur = _average_row(raw, prior, bpp)
        elif ftype == 4:     # Paeth
            cur = _paeth_row(raw, prior, bpp)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prior = cur
    return out


def _gray(samples: np.ndarray, color: int, depth: int, palette: Optional[np.ndarray]) -> np.ndarray:
    """(H, W, channels) samples (uint8 or uint16) -> (H, W) uint8 gray."""
    if color == 3:
        rgb = palette[samples[..., 0]].astype(np.uint32)
        return _rgb_to_gray(rgb, 8)
    if color in (0, 4):
        g = samples[..., 0]
    else:
        g = _rgb_to_gray(samples[..., :3].astype(np.uint32), depth)
    return (g >> 8).astype(np.uint8) if depth == 16 else g.astype(np.uint8)


def _rgb_to_gray(rgb: np.ndarray, depth: int) -> np.ndarray:
    """libpng's png_do_rgb_to_gray without gamma: a pixel with equal
    channels keeps its value, others take the weighted sum (rounded at 16
    bits, truncated at 8)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    s = RED_W * r + GREEN_W * g + BLUE_W * b
    s = (s + 16384) >> 15 if depth == 16 else s >> 15
    return np.where((r == g) & (r == b), r, s)


def decode_png_gray(data: bytes) -> Optional[np.ndarray]:
    """PNG file bytes -> (H, W) uint8 grayscale, or None where the file is
    not a PNG this decoder reads."""
    if data[:8] != SIGNATURE:
        return None
    pos, idat, palette, hdr = 8, [], None, None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None or not idat:
        return None
    width, height, depth, color, _, _, interlace = hdr
    if interlace or color not in _CHANNELS or (color == 3 and palette is None):
        return None
    ch = _CHANNELS[color]
    stride = (width * ch * depth + 7) // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error:
        return None
    if len(raw) < height * (stride + 1):
        return None
    rows = unfilter(raw, height, stride, max(1, ch * depth // 8))
    if depth == 16:
        samples = rows.view(">u2").reshape(height, width, ch)
    elif depth == 8:
        samples = rows.reshape(height, width, ch)
    else:  # 1, 2 or 4 bits: one channel (gray or palette index), MSB first
        bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
        vals = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(-1, dtype=np.uint8)
        samples = vals[:, :width, None]
        if color == 0:
            samples = samples * np.uint8(255 // ((1 << depth) - 1))
    return _gray(samples, color, depth, palette)


def read_png_gray(path: str) -> Optional[np.ndarray]:
    try:
        with open(path, "rb") as f:
            return decode_png_gray(f.read())
    except OSError:
        return None


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def encode_png_gray(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W) values in 0..255 (clipped, cast to uint8) -> an 8-bit grayscale
    PNG with every row filtered by Up (type 2)."""
    a = np.clip(img, 0, 255).astype(np.uint8)
    H, W = a.shape
    up = a - np.concatenate([np.zeros((1, W), np.uint8), a[:-1]])
    rows = np.concatenate([np.full((H, 1), 2, np.uint8), up], axis=1)
    return (SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def write_png_gray(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png_gray(img))
