"""The port's image codec: JPEG and PNG bodies to uint8 RGB and back,
without OpenCV.

`decode` gives what the JAX package gets from `cv2.imdecode(body,
IMREAD_COLOR)` (and `imread` what it gets from `cv2.imread`), with the
channels in RGB order, pixel for pixel:

- JPEG: 8-bit sequential and progressive, Huffman- or arithmetic-coded,
  grey, YCbCr / RGB or four components (CMYK, YCCK), any integral
  sampling factors, restart markers. The C++ in `csrc/codec.cpp` (built
  at first use, called through ctypes, which releases the GIL) repeats
  libjpeg-turbo's entropy decoders (its QM decoder among them), its block
  smoothing of progressive bodies left not fully refined, its integer
  IDCT as its x86 SIMD code computes it, its "fancy" upsampling, its
  colour tables and OpenCV's CMYK -> BGR rule, and libjpeg's and cv2's
  rules for markers and tables; the EXIF orientation is applied as OpenCV
  applies it. Where cv2.imdecode returns nothing -- lossless,
  hierarchical and 12-bit bodies, two or more than four components,
  fractional sampling, a body cut before its data ends -- a `ValueError`
  names why.
- PNG: every colour type and bit depth, all five filters, Adam7.
  IMREAD_COLOR's rules: alpha dropped, 16-bit samples cut to their high
  byte, grey replicated, palette expanded, 1/2/4-bit grey scaled to 8
  bits. zlib inflates; the scanline filters are undone in
  `csrc/codec.cpp`.

`encode_jpeg` writes the stream libjpeg-turbo writes for cv2.imencode at a
quality (standard tables and Huffman codes, islow forward DCT, 4:2:0 by
default); `encode_png` is lossless.
"""
from __future__ import annotations

import ctypes
import os
import struct
import zlib
from typing import Optional

import numpy as np

_ERRORS = {
    1: 'not a JPEG body',
    2: 'corrupt JPEG body',
    5: 'lossless or hierarchical JPEG is not supported',
    6: 'JPEG sample precision other than 8 bits (12-bit JPEG) is not '
       'supported',
    7: 'JPEG with other than 1, 3 or 4 components is not supported',
    8: 'unsupported JPEG sampling factors (fractional, or more than 10 '
       'blocks to an interleaved MCU)',
    9: 'bad JPEG Huffman table: a DC symbol above 15',
    10: 'JPEG without a frame header',
    11: 'output buffer too small',
    12: 'bad image size (at most 65500 a side and 2**28 pixels)',
    13: 'bad or missing JPEG table',
    14: 'bad PNG filter type',
    15: 'out of memory',
    17: 'truncated JPEG body (no end-of-image marker)',
}
MAX_PIXELS = 1 << 28       # csrc/codec.cpp's kMaxPixels
_E_BUFFER = 11
_PNG_SIG = b'\x89PNG\r\n\x1a\n'
# libjpeg-turbo's luma sampling factors for cv2's IMWRITE_JPEG_SAMPLING_*
SAMPLING = {'444': (1, 1), '422': (2, 1), '420': (2, 2), '440': (1, 2),
            '411': (4, 1)}


def _lib():
    from ..ops.cuda import _build
    return _build.library('codec')


def _raise(code: int) -> None:
    if code:
        raise ValueError(_ERRORS.get(code, f'codec error {code}'))


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ApplyExifOrientation."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}
    axes = flip.get(orientation, ())
    return np.ascontiguousarray(np.flip(img, axes) if axes else img)


def decode_jpeg(data) -> np.ndarray:
    """JPEG body -> (H, W, 3) uint8 RGB, as cv2.imdecode(IMREAD_COLOR)."""
    lib = _lib()
    arr = np.frombuffer(data, np.uint8)
    info = (ctypes.c_int * 4)()      # width, height, components, orientation
    _raise(lib.og_jpeg_info(arr.ctypes.data, arr.size, info))
    w, h, _, orientation = info
    out = np.empty((h, w, 3), np.uint8)
    _raise(lib.og_jpeg_decode(arr.ctypes.data, arr.size, out.ctypes.data, w,
                              h))
    return _orient(out, orientation)


def encode_jpeg(image: np.ndarray, quality: int = 95,
                sampling: str = '420', restart_interval: int = 0) -> bytes:
    """(H, W, 3) uint8 RGB, or (H, W) grey -> baseline JPEG body, the
    stream cv2.imencode writes with the same quality, sampling factor and
    restart interval."""
    img = np.ascontiguousarray(image, dtype=np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f'expected (H, W) or (H, W, 3) uint8, got '
                         f'{img.shape}')
    h, w = img.shape[:2]
    if h * w > MAX_PIXELS:
        raise ValueError(_ERRORS[12])
    c = 1 if img.ndim == 2 else 3
    hs, vs = SAMPLING[sampling]
    lib = _lib()
    cap = max(4096, h * w * c * 2 + 2048)
    out_len = ctypes.c_long()
    for _ in range(2):
        out = np.empty(cap, np.uint8)
        code = lib.og_jpeg_encode(img.ctypes.data, w, h, c, int(quality), hs,
                                  vs, int(restart_interval), out.ctypes.data,
                                  cap, ctypes.byref(out_len))
        if code != _E_BUFFER:
            break
        cap = out_len.value
    _raise(code)
    return out[:out_len.value].tobytes()


# ---------------------------------------------------------------- PNG

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7 passes: (row start, column start, row step, column step)
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _unfilter(raw: memoryview, rows: int, cols: int, channels: int,
              depth: int, lib) -> np.ndarray:
    """Filtered scanlines -> (rows, cols, channels) samples (uint16 for
    16-bit, unpacked for 1/2/4-bit)."""
    rowbytes = (cols * channels * depth + 7) // 8
    bpp = max(1, channels * depth // 8)
    need = rows * (rowbytes + 1)
    if len(raw) < need:
        raise ValueError('truncated PNG image data')
    src = np.frombuffer(raw, np.uint8, need)
    out = np.empty((rows, rowbytes), np.uint8)
    _raise(lib.og_png_unfilter(src.ctypes.data, rows, rowbytes, bpp,
                               out.ctypes.data))
    if depth == 16:
        return out.view('>u2').reshape(rows, cols, channels)
    if depth == 8:
        return out.reshape(rows, cols, channels)
    bits = np.unpackbits(out, axis=1).reshape(rows, -1, depth)
    vals = (bits * (1 << np.arange(depth - 1, -1, -1))).sum(-1)
    return vals[:, :cols * channels].astype(np.uint8).reshape(
        rows, cols, channels)


def decode_png(data) -> np.ndarray:
    """PNG body -> (H, W, 3) uint8 RGB, as cv2.imdecode(IMREAD_COLOR)."""
    data = bytes(data)
    if not data.startswith(_PNG_SIG):
        raise ValueError('not a PNG body')
    pos, idat, palette, header = 8, [], None, None
    while pos + 8 <= len(data):
        n, kind = struct.unpack('>I4s', data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + n]
        if len(chunk) < n:
            raise ValueError('truncated PNG chunk')
        pos += 12 + n
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', chunk[:13])
        elif kind == b'PLTE':
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif kind == b'IDAT':
            idat.append(chunk)
        elif kind == b'IEND':
            break
    if header is None or not idat:
        raise ValueError('PNG without IHDR or IDAT')
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f'unsupported PNG: colour type {ctype}, depth '
                         f'{depth}')
    if w < 1 or h < 1 or w * h > MAX_PIXELS:
        raise ValueError(f'bad image size {w}x{h} (at most 2**28 pixels)')
    if ctype == 3 and palette is None:
        raise ValueError('palette PNG without PLTE')
    ch = _CHANNELS[ctype]
    # inflate no more than the scanlines need (with Adam7, less than
    # twice the plain size): a small body cannot claim a large buffer
    need = 2 * h * ((w * ch * depth + 7) // 8 + 1) + 64
    try:
        raw = memoryview(zlib.decompressobj().decompress(b''.join(idat),
                                                         need))
    except zlib.error as e:
        raise ValueError(f'corrupt PNG image data: {e}') from e
    lib = _lib()
    if not interlace:
        px = _unfilter(raw, h, w, ch, depth, lib)
    else:
        px = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
        off = 0
        for r0, c0, dr, dc in _ADAM7:
            rows, cols = -(-(h - r0) // dr), -(-(w - c0) // dc)
            if rows <= 0 or cols <= 0:
                continue
            part = _unfilter(raw[off:], rows, cols, ch, depth, lib)
            px[r0::dr, c0::dc] = part
            off += rows * ((cols * ch * depth + 7) // 8 + 1)
    if depth == 16:
        px = (px >> 8).astype(np.uint8)
    if ctype == 3:
        return palette[np.minimum(px[..., 0], len(palette) - 1)]
    if ctype in (0, 4):
        g = px[..., 0]
        if depth < 8:
            g = g * (255 // ((1 << depth) - 1))
        return np.repeat(g[..., None], 3, axis=2).astype(np.uint8)
    return np.ascontiguousarray(px[..., :3])


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB or (H, W) grey -> 8-bit PNG body (lossless; the
    Sub filter on every row)."""
    img = np.ascontiguousarray(image, dtype=np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    h, w = img.shape[:2]
    ctype, ch = (0, 1) if img.ndim == 2 else (2, 3)
    rows = img.reshape(h, w * ch)
    sub = rows.copy()
    sub[:, ch:] = rows[:, ch:] - rows[:, :-ch]
    raw = np.concatenate([np.ones((h, 1), np.uint8), sub], axis=1)
    return (_PNG_SIG
            + _png_chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, ctype, 0,
                                              0, 0))
            + _png_chunk(b'IDAT', zlib.compress(raw.tobytes()))
            + _png_chunk(b'IEND', b''))


# ------------------------------------------------------------- files

def decode(data) -> np.ndarray:
    """JPEG or PNG body -> (H, W, 3) uint8 RGB; `ValueError` for an empty,
    unknown, unsupported or corrupt body."""
    head = bytes(data[:8])
    if head.startswith(b'\xff\xd8\xff'):    # cv2's JPEG signature
        return decode_jpeg(data)
    if head == _PNG_SIG:
        return decode_png(data)
    raise ValueError('not a JPEG or PNG body')


def imread(path: str) -> Optional[np.ndarray]:
    """(H, W, 3) uint8 RGB of a JPEG or PNG file, or None when the file is
    missing or not an image the codec decodes (cv2.imread's None)."""
    try:
        with open(path, 'rb') as f:
            data = f.read()
        return decode(data)
    except (OSError, ValueError):
        return None


def imwrite(path: str, image: np.ndarray, quality: int = 95) -> None:
    """Write uint8 RGB (or grey) as JPEG (`.jpg` / `.jpeg`) or PNG."""
    ext = os.path.splitext(path)[1].lower()
    if ext in ('.jpg', '.jpeg'):
        body = encode_jpeg(image, quality)
    elif ext == '.png':
        body = encode_png(image)
    else:
        raise ValueError(f'{path}: the codec writes .jpg, .jpeg and .png')
    with open(path, 'wb') as f:
        f.write(body)
