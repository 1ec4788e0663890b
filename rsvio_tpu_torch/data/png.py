"""PNG reading and writing without OpenCV or libpng.

The JAX package reads frames with ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``
(rsvio_tpu/data/players.py) and its native loader links libpng
(rsvio_tpu/native/); the port needs neither. Inflate and deflate come from
the standard library's ``zlib``; the row filters are reversed by a small C++
source (``csrc/png_unfilter.cpp``) built at first use with the host C++
compiler (``ops/cuda/build.build_host_library``) and called through ctypes.
If that build fails the read raises; ``unfilter_numpy`` is the plain version
the tests hold it to, and nothing falls back to it.

Formats read: 8- and 16-bit grayscale, gray+alpha, RGB and RGBA, not
interlaced. ``read_gray`` converts them as ``cv2.IMREAD_GRAYSCALE`` does:
16-bit samples keep their high byte, alpha is dropped, and colour becomes
(9797 R + 19234 G + 3737 B) >> 15, libpng's fixed-point weights for 0.299 /
0.587 / 0.114 (rounded, at 16 bits, for 16-bit colour). Palette images,
interlaced images and other bit depths raise
``ValueError`` naming the header fields. Chunk CRCs and the ``IHDR`` fields
are checked, and a truncated file raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib
from typing import NamedTuple, Sequence, Union

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels; 3 (palette) is not read
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
FILTERS = (0, 1, 2, 3, 4)   # None, Sub, Up, Average, Paeth
RGB_TO_GRAY = (9797, 19234, 3737)   # / 2**15


class Header(NamedTuple):
    width: int
    height: int
    bit_depth: int
    color_type: int
    interlace: int

    @property
    def bpp(self) -> int:
        """Bytes per complete pixel."""
        return CHANNELS[self.color_type] * self.bit_depth // 8


def _fields(h: Header) -> str:
    return (f"width={h.width} height={h.height} bit_depth={h.bit_depth} "
            f"color_type={h.color_type} interlace={h.interlace}")


def _chunks(data: bytes, path: str):
    """(type, payload) of each chunk after the signature, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (bad signature)")
    i = 8
    while True:
        if i + 8 > len(data):
            raise ValueError(f"{path}: truncated PNG (no IEND chunk)")
        n, ctype = struct.unpack(">I4s", data[i:i + 8])
        if i + 12 + n > len(data):
            raise ValueError(f"{path}: truncated PNG (chunk "
                             f"{ctype.decode('latin-1')} cut short)")
        payload = data[i + 8:i + 8 + n]
        (crc,) = struct.unpack(">I", data[i + 8 + n:i + 12 + n])
        if zlib.crc32(ctype + payload) != crc:
            raise ValueError(f"{path}: CRC mismatch in chunk "
                             f"{ctype.decode('latin-1')}")
        yield ctype, payload
        if ctype == b"IEND":
            return
        i += 12 + n


def _header(payload: bytes, path: str) -> Header:
    if len(payload) != 13:
        raise ValueError(f"{path}: IHDR has {len(payload)} bytes, not 13")
    w, h, depth, ctype, comp, filt, il = struct.unpack(">IIBBBBB", payload)
    hd = Header(w, h, depth, ctype, il)
    if w == 0 or h == 0 or comp != 0 or filt != 0:
        raise ValueError(f"{path}: invalid IHDR ({_fields(hd)} "
                         f"compression={comp} filter={filt})")
    if ctype not in CHANNELS or depth not in (8, 16) or il != 0:
        raise ValueError(
            f"{path}: unsupported PNG ({_fields(hd)}); the reader takes 8- "
            f"or 16-bit gray (0), RGB (2), gray+alpha (4) and RGBA (6), "
            f"not interlaced")
    return hd


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (at first use) and load the C++ unfilter; returns
    build.Built."""
    from ..ops.cuda.build import build_host_library

    built = build_host_library("png_unfilter", ["png_unfilter.cpp"])
    fn = built.lib.png_unfilter
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return built


def unfilter(raw: bytes, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Reverse the row filters of `raw` (height rows of a filter byte and
    `row_bytes` bytes) with the C++ library: (height, row_bytes) uint8."""
    out = np.empty((height, row_bytes), np.uint8)
    rc = load_library().lib.png_unfilter(raw, out.ctypes.data, height,
                                         row_bytes, bpp)
    if rc != 0:
        raise ValueError(f"row {rc - 1}: unknown PNG filter type "
                         f"{raw[(rc - 1) * (row_bytes + 1)]}")
    return out


def unfilter_numpy(raw: bytes, height: int, row_bytes: int,
                   bpp: int) -> np.ndarray:
    """The plain version of `unfilter`: Sub as a cumulative sum mod 256 per
    byte lane, Up as one add, Average and Paeth one byte after another."""
    rows = np.frombuffer(raw, np.uint8).reshape(height, row_bytes + 1)
    out = np.zeros((height, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.int64)
    for y in range(height):
        ftype, cur = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if ftype == 0:
            r = cur
        elif ftype == 1:
            r = np.empty_like(cur)
            for j in range(bpp):
                r[j::bpp] = np.cumsum(cur[j::bpp]) % 256
        elif ftype == 2:
            r = (cur + prev) % 256
        elif ftype in (3, 4):
            r = np.zeros_like(cur)
            for x in range(row_bytes):
                a = int(r[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = int(prev[x - bpp]) if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                            else c)
                r[x] = (int(cur[x]) + pred) % 256
        else:
            raise ValueError(f"row {y}: unknown PNG filter type {ftype}")
        out[y] = r
        prev = r
    return out


def read_png(path: str, unfilter_fn=None) -> np.ndarray:
    """Decode a PNG file into its samples: (H, W) or (H, W, C) uint8 or
    uint16, as stored (no conversion). `unfilter_fn` defaults to the C++
    `unfilter`."""
    with open(path, "rb") as f:
        data = f.read()
    hd, idat = None, []
    for ctype, payload in _chunks(data, path):
        if ctype == b"IHDR":
            hd = _header(payload, path)
        elif hd is None:
            raise ValueError(f"{path}: first chunk is not IHDR")
        elif ctype == b"IDAT":
            idat.append(payload)
        elif ctype[0:1].isupper() and ctype not in (b"PLTE", b"IEND"):
            raise ValueError(f"{path}: unknown critical chunk "
                             f"{ctype.decode('latin-1')}")
    if not idat:
        raise ValueError(f"{path}: no image data (IDAT)")
    try:
        d = zlib.decompressobj()
        raw = d.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from e
    row_bytes = hd.width * hd.bpp
    if not d.eof or len(raw) != hd.height * (row_bytes + 1):
        raise ValueError(f"{path}: truncated image data ({len(raw)} of "
                         f"{hd.height * (row_bytes + 1)} bytes; "
                         f"{_fields(hd)})")
    px = (unfilter_fn or unfilter)(raw, hd.height, row_bytes, hd.bpp)
    if hd.bit_depth == 16:
        px = px.view(">u2").astype(np.uint16)
    c = CHANNELS[hd.color_type]
    return px.reshape(hd.height, hd.width, c) if c > 1 else \
        px.reshape(hd.height, hd.width)


def _to_gray_u8(px: np.ndarray) -> np.ndarray:
    """Samples from read_png -> (H, W) uint8 gray, as cv2.IMREAD_GRAYSCALE
    converts them."""
    if px.ndim == 3 and px.shape[2] <= 2:    # gray+alpha: drop alpha
        px = px[..., 0]
    if px.ndim == 3:
        rgb = px[..., :3].astype(np.uint64)
        wr, wg, wb = RGB_TO_GRAY
        # 16-bit colour is weighted at 16 bits (rounded), then cut to 8.
        rnd = 1 << 14 if px.dtype == np.uint16 else 0
        px = ((rgb[..., 0] * wr + rgb[..., 1] * wg + rgb[..., 2] * wb + rnd)
              >> 15).astype(px.dtype)
    if px.dtype == np.uint16:
        px = px >> 8
    return np.ascontiguousarray(px, dtype=np.uint8)


def read_gray_u8(path: str) -> np.ndarray:
    """(H, W) uint8 gray image of a PNG file."""
    return _to_gray_u8(read_png(path))


def read_gray(path: str) -> np.ndarray:
    """(H, W) float32 gray image of a PNG file, equal to
    ``cv2.imread(path, cv2.IMREAD_GRAYSCALE).astype(np.float32)``."""
    return read_gray_u8(path).astype(np.float32)


def _filter_rows(px: np.ndarray, bpp: int, ftypes: np.ndarray) -> np.ndarray:
    """Row y of `px` (H, row_bytes) filtered with type ftypes[y]."""
    r = px.astype(np.int16)
    a = np.zeros_like(r)
    a[:, bpp:] = r[:, :-bpp]
    b = np.zeros_like(r)
    b[1:] = r[:-1]
    out = r.copy()
    for t in FILTERS[1:]:
        m = ftypes == t
        if not m.any():
            continue
        rm, am, bm = r[m], a[m], b[m]
        if t == 1:
            out[m] = rm - am
        elif t == 2:
            out[m] = rm - bm
        elif t == 3:
            out[m] = rm - ((am + bm) >> 1)
        else:
            cm = np.zeros_like(rm)
            cm[:, bpp:] = bm[:, :-bpp]
            p = am + bm - cm
            pa, pb, pc = np.abs(p - am), np.abs(p - bm), np.abs(p - cm)
            out[m] = rm - np.where((pa <= pb) & (pa <= pc), am,
                                   np.where(pb <= pc, bm, cm))
    return (out % 256).astype(np.uint8)


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def write_png(path: str, img: np.ndarray,
              filters: Union[None, int, Sequence[int]] = None) -> None:
    """Write `img` as a PNG: (H, W) gray, (H, W, 2) gray+alpha, (H, W, 3)
    RGB or (H, W, 4) RGBA, uint8 or uint16. `filters` is the filter type of
    every row (0-4: None, Sub, Up, Average, Paeth), one type for all rows,
    or None for type 0. Raises on a failed write."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes uint8 or uint16, got {img.dtype}")
    chans = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}.get(chans) if img.ndim in (2, 3) \
        else None
    if ctype is None:
        raise ValueError(f"write_png takes (H, W) or (H, W, 2|3|4), got "
                         f"{img.shape}")
    h, w = img.shape[:2]
    depth = 16 if img.dtype == np.uint16 else 8
    px = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    px = px.view(np.uint8).reshape(h, -1)
    bpp = chans * depth // 8
    if filters is None or np.isscalar(filters):
        ftypes = np.full(h, 0 if filters is None else int(filters))
    else:
        ftypes = np.asarray(filters, dtype=np.int64)
        if ftypes.shape != (h,):
            raise ValueError(f"filters: {ftypes.shape[0]} types for {h} rows")
    if not np.isin(ftypes, FILTERS).all():
        raise ValueError(f"filter types must be 0-4, got "
                         f"{set(ftypes.tolist())}")
    rows = _filter_rows(px, bpp, ftypes)
    raw = np.concatenate([ftypes.astype(np.uint8)[:, None], rows], axis=1)
    data = (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def cycle_filters(height: int, offset: int = 0) -> np.ndarray:
    """Row filter types 0, 1, 2, 3, 4, 0, ... (from `offset`): a file that
    exercises all five."""
    return (np.arange(height) + offset) % len(FILTERS)

