"""8-bit RGB PNG files with numpy and ``zlib`` alone.

The JAX trainer writes its frames with ``cv2.imwrite``; the port may run
where no image library is installed, so it writes them itself. The
encoder writes every scanline with filter type 0 (None) in one IDAT
chunk; the decoder reads such files back (it refuses other filter types,
interlacing and other color types).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """img: [H, W, 3] uint8 (RGB)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png: needs [H, W, 3] uint8, got {img.shape} {img.dtype}")
    H, W, _ = img.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, W * 3)], axis=1)
    # 8-bit depth, color type 2 (RGB), deflate, filter method 0, no interlace
    header = struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """A file ``write_png`` wrote -> [H, W, 3] uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        elif kind == b"IEND":
            break
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: only 8-bit RGB, non-interlaced PNGs are read")
    W, H = header[0], header[1]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, 1 + 3 * W)
    if rows[:, 0].any():
        raise ValueError(f"{path}: only scanline filter type 0 is read")
    return rows[:, 1:].reshape(H, W, 3).copy()
