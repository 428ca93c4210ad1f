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
  input it computes in float64 and rounds once to float32 (OpenCV 5's float
  path, through its IPP back end, rounds otherwise: within 1 ulp of the
  result, where both source pixels are finite). With
  ``interpolation='nearest'`` it is OpenCV's ``INTER_NEAREST``, exactly.
- :func:`fill_poly` is ``cv2.fillPoly(img, pts, value)`` (8-connected
  edges), pixel for pixel, for the masks of polygon annotations
  (``arfe_tpu/core/mask/structures.py:196-206``, ``rle.py:65-85``).
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

def _nearest_index(src_size, dst_size):
    """OpenCV's ``INTER_NEAREST`` source index of each output position:
    ``floor(d * (1 / (dst / src)))`` in double, clamped to the last."""
    scale = 1.0 / (dst_size / src_size)
    return np.minimum(np.floor(np.arange(dst_size) * scale).astype(np.int64),
                      src_size - 1)


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


def imresize(img, size, interpolation='bilinear', window=None):
    """``cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)``, or
    ``cv2.INTER_NEAREST`` with ``interpolation='nearest'``.

    Args:
        img: (H, W) or (H, W, C) uint8 or float array.
        size: (width, height) of the output, as OpenCV takes it.
        window: for float input, (rows, cols) slices: only that part of
            the output is computed and returned.
    Returns:
        the resized array, of ``img``'s dtype (float input: float32; the
        nearest resize keeps any dtype).
    """
    new_w, new_h = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if new_w <= 0 or new_h <= 0 or h <= 0 or w <= 0:
        raise ValueError(f'imresize: {w}x{h} to {size}: an empty image')
    if interpolation == 'nearest':
        return img[_nearest_index(h, new_h)][:, _nearest_index(w, new_w)]
    if interpolation != 'bilinear':
        raise ValueError(f'imresize: interpolation {interpolation!r}')
    src = img.reshape(h, w, -1)
    if window is not None:
        if img.dtype == np.uint8:
            raise ValueError('imresize: a window of a uint8 resize')
        out = _resize_float(src, new_w, new_h, *window)
        return out.reshape(out.shape[:2] + img.shape[2:])
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


def _float_axis(src_size, dst_size, window=None):
    """The two source indices and the second one's weight of each output
    position (or of ``window``, a slice of them), in float64: the
    pixel-centre mapping ``(d + 0.5) * src / dst - 0.5``; a position before
    the first or at or past the last source pixel takes that pixel
    alone."""
    d = np.arange(dst_size)[window if window is not None else slice(None)]
    f = (d + 0.5) * (src_size / dst_size) - 0.5
    s = np.floor(f).astype(np.int64)
    frac = f - s
    edge = (s < 0) | (s >= src_size - 1)
    frac[edge] = 0.0
    s = np.clip(s, 0, src_size - 1)
    return s, np.minimum(s + 1, src_size - 1), frac


def _resize_float(src, new_w, new_h, rows=None, cols=None):
    """The bilinear resize of (H, W, C) ``src`` in float64, rounded once to
    float32; ``rows`` and ``cols`` (slices) compute only that window of the
    output. OpenCV 5's float path lies within one float32 ulp of it."""
    h, w = src.shape[:2]
    x0, x1, fx = _float_axis(w, new_w, cols)
    y0, y1, fy = _float_axis(h, new_h, rows)
    # the horizontal pass on the source rows the window needs
    need = np.unique(np.concatenate([y0, y1]))
    part = src[need].astype(np.float64)
    fx = fx[None, :, None]
    horiz = part[:, x0] * (1.0 - fx) + part[:, x1] * fx
    r0, r1 = np.searchsorted(need, y0), np.searchsorted(need, y1)
    fy = fy[:, None, None]
    return (horiz[r0] * (1.0 - fy) + horiz[r1] * fy).astype(np.float32)


# --------------------------------------------------------------------------
# polygon filling
# --------------------------------------------------------------------------

# OpenCV's drawing code keeps x in 16-bit fixed point
_XY_SHIFT = 16


def _cdiv(a, b):
    """C's integer division, the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(w, h, p1, p2):
    """OpenCV's ``clipLine`` of the integer segment p1-p2 to the image's
    pixels: whether any of it lies inside, and the endpoints, moved onto
    the border where they lay outside (the moves made before it finds the
    segment outside are kept, as OpenCV keeps them)."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        # the shifts are computed in double and truncated, as OpenCV does
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _inside(w, h, *points):
    return all(0 <= x < w and 0 <= y < h for x, y in points)


def _draw_line(img, p1, p2, value):
    """OpenCV's 8-connected ``Line`` (``LineIterator`` left to right): the
    segment clipped to the image, then Bresenham's pixels, the minor axis
    stepping where the error ``dx - 2 dy (k + 1) + 2 dx m_k`` is negative,
    which gives ``m_k = ceil((2 dy k - dx) / (2 dx))`` minor steps by step
    k."""
    h, w = img.shape
    if not _inside(w, h, p1, p2):
        ok, p1, p2 = _clip_line(w, h, p1, p2)
        if not ok:
            return
    (x1, y1), (x2, y2) = p1, p2
    if x2 < x1:
        (x1, y1), (x2, y2) = (x2, y2), (x1, y1)
    dx, dy = x2 - x1, abs(y2 - y1)
    sy = 1 if y2 >= y1 else -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    k = np.arange(dx + 1, dtype=np.int64)
    minor = -((dx - 2 * dy * k) // (2 * dx)) if dx else k
    if vert:
        img[y1 + sy * k, x1 + minor] = value
    else:
        img[y1 + sy * minor, x1 + k] = value


def _polygon_edges(img, pts, value, edges):
    """OpenCV's ``CollectPolyEdges`` for one closed polygon of integer
    points: draws each side as a line and appends its non-horizontal sides
    as ``[y0, y1, x at y0, dx per row]`` (x in fixed point). A side with an
    end outside the image is taken between its clipped ends, as OpenCV 5
    takes it (slope 0 where they share a row)."""
    h, w = img.shape
    one = 1 << _XY_SHIFT
    n = len(pts)
    for i in range(n):
        (ax, ay), (bx, by) = pts[i - 1], pts[i]
        _draw_line(img, (ax, ay), (bx, by), value)
        c0, c1 = (ax * one, ay), (bx * one, by)
        if not _inside(w, h, (ax, ay), (bx, by)):
            _, q0, q1 = _clip_line(w, h, (ax, ay), (bx, by))
            c0, c1 = (q0[0] * one, q0[1]), (q1[0] * one, q1[1])
        if ay == by:
            continue
        dx = _cdiv(c1[0] - c0[0], c1[1] - c0[1]) if c1[1] != c0[1] else 0
        if ay < by:
            edges.append([ay, by, c0[0] + (ay - c0[1]) * dx, dx])
        else:
            edges.append([by, ay, c1[0] + (by - c1[1]) * dx, dx])


def _fill_edges(img, edges, value):
    """OpenCV's ``FillEdgeCollection``: an active edge list, sorted by x
    and walked row by row; each pair of edges fills the pixels from the
    ceiling of the left crossing to the floor of the right one, and both
    advance by their slope; an edge leaves the list at its last row."""
    h, w = img.shape
    if len(edges) < 2:
        return
    xs = [e[2] for e in edges] + [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    if max(e[1] for e in edges) < 0 or min(e[0] for e in edges) >= h \
            or max(xs) < 0 or min(xs) >= w << _XY_SHIFT:
        return
    edges.sort(key=lambda e: (e[0], e[2], e[3]))
    ceil = (1 << _XY_SHIFT) - 1
    y_end = min(max(e[1] for e in edges), h)
    nxt, active = 0, []
    for y in range(edges[0][0], y_end):
        walked, left = [], None
        j = 0
        while j < len(active) or (nxt < len(edges) and edges[nxt][0] == y):
            last = active[j] if j < len(active) else None
            if last is not None and last[1] == y:
                j += 1        # the edge ends above this row
                continue
            new = edges[nxt] if nxt < len(edges) else None
            if last is not None and (new is None or new[0] > y
                                     or last[2] < new[2]):
                cur, j = last, j + 1
            elif new is not None:
                cur, nxt = new, nxt + 1
            else:
                break
            walked.append(cur)
            if left is None:
                left = cur
                continue
            if y >= 0:
                lo, hi = sorted((left[2], cur[2]))
                x1, x2 = (lo + ceil) >> _XY_SHIFT, hi >> _XY_SHIFT
                if x1 < w and x2 >= 0:
                    img[y, max(x1, 0):min(x2, w - 1) + 1] = value
            left[2] += left[3]
            cur[2] += cur[3]
            left = None
        # a bubble sort by x, as OpenCV's (stable)
        active = walked
        for end in range(len(active) - 1, 0, -1):
            swapped = False
            for k in range(end):
                if active[k][2] > active[k + 1][2]:
                    active[k], active[k + 1] = active[k + 1], active[k]
                    swapped = True
            if not swapped:
                break


def fill_poly(img, polygons, value=1):
    """``cv2.fillPoly(img, polygons, value)`` on a 2-D array, in place:
    each polygon's sides drawn as 8-connected lines, then the pixels between
    pairs of side crossings filled, all polygons at once (even-odd).

    Args:
        img: (H, W) array.
        polygons: (N, 2) integer arrays of (x, y) points, N >= 1.
    """
    edges = []
    for poly in polygons:
        pts = [(int(x), int(y)) for x, y in np.asarray(poly).reshape(-1, 2)]
        if not pts:
            raise ValueError('fill_poly: a polygon without points')
        _polygon_edges(img, pts, value, edges)
    _fill_edges(img, edges, value)
    return img
