"""Image IO: PNG/NumPy dump of render output (port of the JAX package's
io/image.py).

The reference displays through an ImGui viewport texture; headless, the
equivalent capability is saving the accumulation buffer to disk.  PIL
writes and reads the PNG when it is installed; otherwise a minimal zlib
encoder and the matching decoder do.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def write_png(path: str, img_u8: np.ndarray) -> None:
    img_u8 = np.ascontiguousarray(img_u8)
    if img_u8.dtype != np.uint8:
        raise ValueError("write_png expects uint8 HxWx3")
    try:
        from PIL import Image
    except ImportError:  # minimal fallback writer
        _write_png_zlib(path, img_u8)
        return
    Image.fromarray(img_u8, "RGB").save(path)


def _write_png_zlib(path: str, img_u8: np.ndarray) -> None:
    h, w, _ = img_u8.shape
    raw = b"".join(b"\x00" + img_u8[r].tobytes() for r in range(h))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))


def write_npy(path: str, img: np.ndarray) -> None:
    np.save(path, np.asarray(img))


def read_png(path: str) -> np.ndarray:
    """Read an RGB8 PNG back as (H, W, 3) uint8 (PIL, or the minimal
    decoder matching write_png's fallback encoder)."""
    try:
        from PIL import Image
    except ImportError:
        return _read_png_zlib(path)
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _read_png_zlib(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, w, h = 8, None, None
    idat = b""
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + ln]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            if depth != 8 or ctype != 2:
                raise ValueError("fallback reader handles RGB8 only")
        elif tag == b"IDAT":
            if w is None:
                raise ValueError(f"{path}: IDAT before any IHDR chunk")
            idat += body
        pos += 12 + ln
    if w is None:
        raise ValueError(f"{path}: no IHDR chunk")
    raw = zlib.decompress(idat)
    stride = w * 3 + 1
    rows = []
    prev = np.zeros(w * 3, np.uint8)
    for r in range(h):
        line = raw[r * stride:(r + 1) * stride]
        filt, px = line[0], np.frombuffer(line[1:], np.uint8).copy()
        if filt == 0:
            pass
        elif filt == 2:   # Up
            px = (px.astype(np.uint16) + prev).astype(np.uint8)
        else:
            raise ValueError(f"fallback reader: unsupported filter {filt}")
        rows.append(px)
        prev = px
    return np.stack(rows).reshape(h, w, 3)
