"""Image reading, writing and resizing without OpenCV.

The JAX package reads images with ``cv2.imread(path, IMREAD_COLOR)`` and
resizes them with ``cv2.resize(..., INTER_LINEAR)``
(``arfe_tpu/data/pipelines.py:55-57,80,186-187``). The port's machines have
no OpenCV, so this module gives the same arrays:

- :func:`imread` decodes PNG itself (stdlib ``zlib`` and numpy: 8-bit grey,
  grey + alpha, RGB and RGBA, all five row filters, not interlaced) and any
  other format, JPEG among them, through PIL where PIL imports. It returns
  BGR uint8 (H, W, 3), as OpenCV does.
- :func:`imresize` is OpenCV's bilinear resize. On uint8 it takes OpenCV's
  11-bit fixed-point arithmetic, so that it gives the same bytes; on float
  input it computes in float32 (OpenCV's float path rounds differently, a
  few 1e-5 of the value range).
- :func:`imwrite_png` writes an 8-bit PNG with filter 0, for synthetic data
  sets.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
# channels per PNG colour type: grey, RGB, grey + alpha, RGBA (palette, 3,
# is not read)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
# OpenCV's fixed-point resize: coefficients are multiples of 2^-11
_COEF_SCALE = 2048


# --------------------------------------------------------------------------
# reading
# --------------------------------------------------------------------------

def imread(path):
    """The image at ``path`` as BGR uint8 (H, W, 3), as ``cv2.imread(path,
    cv2.IMREAD_COLOR)`` gives it (alpha dropped, grey repeated).

    Raises ``FileNotFoundError`` for a missing file, ``ValueError`` naming
    the file for a PNG this reader does not decode (palette, 16-bit,
    interlaced), and ``ImportError`` naming the file for a non-PNG file
    where PIL is not installed.
    """
    with open(path, 'rb') as f:
        data = f.read()
    if data.startswith(_PNG_SIGNATURE):
        img = _decode_png(data, path)
    else:
        img = _decode_with_pil(path)
    if img.shape[2] >= 3:
        return np.ascontiguousarray(img[..., 2::-1])   # RGB(A) -> BGR
    return np.ascontiguousarray(np.repeat(img[..., :1], 3, axis=2))


def _decode_with_pil(path):
    """RGB uint8 (H, W, 3) through PIL, turned as the file's EXIF
    orientation says (``cv2.imread`` applies it; PIL does not by itself)."""
    try:
        from PIL import Image, ImageOps
    except ImportError as e:
        raise ImportError(f'{path}: only PNG is decoded without PIL, which '
                          'is not installed') from e
    with Image.open(path) as im:
        im = ImageOps.exif_transpose(im)
        return np.asarray(im.convert('RGB'))


def _decode_png(data, path):
    """(H, W, C) uint8 of an 8-bit PNG: C is 1 (grey), 2 (grey + alpha),
    3 (RGB) or 4 (RGBA)."""
    pos, header, idat = len(_PNG_SIGNATURE), None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
    if header is None or not idat:
        raise ValueError(f'{path}: not a complete PNG file')
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(
            f'{path}: PNG with bit depth {depth}, colour type {color}, '
            f'interlace {interlace} is not read (8-bit grey, grey + alpha, '
            'RGB or RGBA, not interlaced, only)')
    bpp = _PNG_CHANNELS[color]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    if raw.size < height * (stride + 1):
        raise ValueError(f'{path}: PNG image data is truncated')
    rows = raw[:height * (stride + 1)].reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:      # Sub: a running sum of each channel, mod 256
            cur = np.cumsum(line.reshape(width, bpp), axis=0,
                            dtype=np.uint8).reshape(stride)
        elif kind == 2:      # Up
            cur = line + prior
        elif kind in (3, 4):
            cur = _unfilter_scan(line, prior, bpp, kind)
        else:
            raise ValueError(f'{path}: PNG row {y} has filter type {kind}')
        out[y] = cur
        prior = cur
    return out.reshape(height, width, bpp)


def _unfilter_scan(line, prior, bpp, kind):
    """The Average (3) and Paeth (4) filters, which depend on the pixel to
    the left as reconstructed: a scan along the row."""
    cur = bytearray(line.tobytes())
    up = prior.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


# --------------------------------------------------------------------------
# writing
# --------------------------------------------------------------------------

def imwrite_png(path, img):
    """Write a BGR (H, W, 3), BGRA (H, W, 4) or grey (H, W) uint8 array as
    an 8-bit PNG with filter 0 on every row, which :func:`imread` and
    ``cv2.imread`` read back as the same BGR bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f'imwrite_png: uint8 only, got {img.dtype}')
    if img.ndim == 2:
        pixels, color = img[..., None], 0
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        order = [2, 1, 0, 3][:img.shape[2]]       # BGR(A) -> RGB(A)
        pixels, color = img[..., order], 2 if img.shape[2] == 3 else 6
    else:
        raise ValueError(f'imwrite_png: shape {img.shape} is not an image')
    height, width = pixels.shape[:2]
    rows = np.concatenate([np.zeros((height, 1), np.uint8),
                           pixels.reshape(height, -1)], axis=1)

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body
                + struct.pack('>I', zlib.crc32(kind + body) & 0xFFFFFFFF))

    header = struct.pack('>IIBBBBB', width, height, 8, color, 0, 0, 0)
    with open(path, 'wb') as f:
        f.write(_PNG_SIGNATURE + chunk(b'IHDR', header)
                + chunk(b'IDAT', zlib.compress(rows.tobytes(), 1))
                + chunk(b'IEND', b''))


# --------------------------------------------------------------------------
# resizing
# --------------------------------------------------------------------------

def _linear_coeffs(src_size, dst_size):
    """OpenCV's source index and fraction of each output position: the
    pixel-centre mapping ``(d + 0.5) * scale - 0.5`` computed in double and
    rounded to float, with ``scale = 1 / (dst / src)``."""
    scale = 1.0 / (dst_size / src_size)
    f = ((np.arange(dst_size) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, (f - s.astype(np.float32)).astype(np.float32)


def _fixed(weight):
    """``saturate_cast<short>(w * 2048)``: round half to even."""
    return np.rint(weight * np.float32(_COEF_SCALE)).astype(np.int32)


def imresize(img, size):
    """``cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)``.

    Args:
        img: (H, W) or (H, W, C) uint8 or float array.
        size: (width, height) of the output, as OpenCV takes it.
    Returns:
        the resized array, of ``img``'s dtype (float input: float32).
    """
    new_w, new_h = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if new_w <= 0 or new_h <= 0:
        raise ValueError(f'imresize: output size {size} is empty')
    src = img.reshape(h, w, -1)
    if img.dtype == np.uint8:
        if (w, h) == (2 * new_w, 2 * new_h):
            # OpenCV takes an exact halving through its area resize: the
            # rounded mean of each 2 x 2 block
            s = src.astype(np.int32)
            out = (s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2]
                   + s[1::2, 1::2] + 2) >> 2
        else:
            out = _resize_fixed(src, new_w, new_h)
        out = out.astype(np.uint8)
    else:
        out = _resize_float(src.astype(np.float32), new_w, new_h)
    return out.reshape((new_h, new_w) + img.shape[2:])


def _horizontal(src_w, new_w):
    """Source columns and their fractions, as OpenCV's horizontal pass
    takes them: positions before the first column take it alone (fraction
    0), positions at or past the last column take it alone."""
    sx, fx = _linear_coeffs(src_w, new_w)
    before = sx < 0
    fx[before], sx[before] = 0, 0
    past = sx >= src_w - 1
    fx[past], sx[past] = 0, src_w - 1
    return sx, np.minimum(sx + 1, src_w - 1), fx


def _vertical(src_h, new_h):
    """Source rows and their fractions: the fraction is kept where the row
    index is clamped at either border (both rows are then the same)."""
    sy, fy = _linear_coeffs(src_h, new_h)
    return np.clip(sy, 0, src_h - 1), np.clip(sy + 1, 0, src_h - 1), fy


def _resize_fixed(src, new_w, new_h):
    """OpenCV's uint8 bilinear resize (``resizeGeneric_`` with
    ``HResizeLinear`` and the SIMD ``VResizeLinearVec_32s8u``), as int32
    (new_h, new_w, C)."""
    h, w = src.shape[:2]
    x0, x1, fx = _horizontal(w, new_w)
    rows = np.take(src, x0, axis=1).astype(np.int32)
    rows *= _fixed(np.float32(1) - fx)[None, :, None]
    rows += np.take(src, x1, axis=1).astype(np.int32) \
        * _fixed(fx)[None, :, None]
    y0, y1, fy = _vertical(h, new_h)
    # the vertical pass on rows pre-shifted by 4 bits, each product's high
    # 16 bits, then a rounding shift by 2: ((r0 b0 >> 16) + (r1 b1 >> 16)
    # + 2) >> 2
    rows >>= 4
    out = np.take(rows, y0, axis=0)
    out *= _fixed(np.float32(1) - fy)[:, None, None]
    out >>= 16
    second = np.take(rows, y1, axis=0)
    second *= _fixed(fy)[:, None, None]
    second >>= 16
    out += second
    out += 2
    out >>= 2
    return np.clip(out, 0, 255, out=out)


def _resize_float(src, new_w, new_h):
    """The bilinear resize in float32, OpenCV's coefficients."""
    h, w = src.shape[:2]
    x0, x1, fx = _horizontal(w, new_w)
    a0 = (np.float32(1) - fx)[None, :, None]
    rows = src[:, x0] * a0 + src[:, x1] * fx[None, :, None]
    y0, y1, fy = _vertical(h, new_h)
    b0 = (np.float32(1) - fy)[:, None, None]
    return rows[y0] * b0 + rows[y1] * fy[:, None, None]
