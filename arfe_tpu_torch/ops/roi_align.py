"""FPN RoIAlign (detectron2-aligned) over NHWC levels, and its gradient.

Counterpart of ``arfe_tpu/ops/roi_align.py`` (``map_roi_levels``,
``roi_align_pyramid``) and of the Pallas kernels
``arfe_tpu/ops/pallas_roi_align.py::roi_align_pallas`` and
``roi_align_pallas_bwd``. :func:`roi_align_pyramid` runs
:class:`RoIAlignFunction`: on CUDA tensors its forward launches the
hand-written kernel in ``csrc/roi_align.cu`` and its backward the one in
``csrc/roi_align_bwd.cu``; on CPU tensors they run
:func:`roi_align_pyramid_plain` and :func:`roi_align_backward_plain`, the
plain PyTorch versions the kernels are held against. There is no fallback
from one to the other. As in the JAX package's VJP
(``pallas_roi_align.py:407-435``), the RoIs get no gradient.

``sample_num=0`` (the reference's adaptive sampling) is replaced by a fixed
2 x 2 grid per bin, as in the JAX package.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .cuda_build import library

#: forward kernel launches since the last reset (``launches = 0``)
launches = 0
#: gradient kernel launches since the last reset (``bwd_launches = 0``)
bwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_LEVELS = 4


def map_roi_levels(rois, num_levels, finest_scale=56):
    """Scale-based FPN level of each RoI (R, 5) -> (R,) int32."""
    scale = torch.sqrt(torch.clamp(
        (rois[:, 3] - rois[:, 1]) * (rois[:, 4] - rois[:, 2]), min=0.0))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return torch.clamp(lvl, 0, num_levels - 1).to(torch.int32)


def _level_scales(featmap_strides):
    return np.array([1.0 / s for s in featmap_strides], np.float32)


def _sample_offsets(out, sn):
    """Position of each of the out * sn samples, in bins from the RoI start."""
    i = np.arange(out * sn)
    return (i // sn + ((i % sn) + 0.5) / sn).astype(np.float32)


def _bilinear_params(coord, size):
    """(i0, i1, w0, w1, valid) along one axis; ``size`` is a float tensor."""
    valid = (coord > -1.0) & (coord < size)
    c = torch.minimum(torch.clamp(coord, min=0.0), size - 1.0)
    i0 = torch.floor(c).long()
    i1 = torch.minimum(i0 + 1, (size - 1.0).long())
    w1 = c - i0.float()
    return i0, i1, 1.0 - w1, w1, valid


def axis_samples(level_shapes, rois, target_lvls, out_size=(7, 7),
                 featmap_strides=(4, 8, 16, 32), sample_num=2, aligned=True):
    """The bilinear parameters of every RoI's samples along each axis.

    ``level_shapes`` are the (B, Hl, Wl) of the levels. Returns ``(ys, xs,
    base, width)``: ``ys`` and ``xs`` are the ``(i0, i1, w0, w1, valid)`` of
    the (R, oh*sn) y samples and the (R, ow*sn) x samples on each RoI's
    level, ``base`` the (R,) row of each RoI's image in the levels packed
    one after the other as (sum B*Hl*Wl, C), and ``width`` the (R,) width
    of each RoI's level. A sample's weight on a corner is the product of
    its two axes' weights, and the sample is valid where both axes are.
    """
    oh, ow = out_size
    sn = sample_num
    dev = rois.device
    sizes = torch.tensor([(s[1], s[2]) for s in level_shapes],
                         dtype=torch.long, device=dev)
    offsets = torch.tensor(
        np.concatenate([[0], np.cumsum([s[0] * s[1] * s[2]
                                        for s in level_shapes])[:-1]]),
        dtype=torch.long, device=dev)
    scales = torch.from_numpy(_level_scales(featmap_strides)).to(dev)

    lvl = target_lvls.long()
    lvl_h, lvl_w = sizes[lvl, 0], sizes[lvl, 1]
    lvl_scale = scales[lvl]
    base = offsets[lvl] + rois[:, 0].long() * lvl_h * lvl_w

    offset = 0.5 if aligned else 0.0
    x1 = rois[:, 1] * lvl_scale - offset
    y1 = rois[:, 2] * lvl_scale - offset
    x2 = rois[:, 3] * lvl_scale - offset
    y2 = rois[:, 4] * lvl_scale - offset
    roi_w, roi_h = x2 - x1, y2 - y1
    if not aligned:
        roi_w = torch.clamp(roi_w, min=1.0)
        roi_h = torch.clamp(roi_h, min=1.0)
    iy = torch.from_numpy(_sample_offsets(oh, sn)).to(dev)
    ix = torch.from_numpy(_sample_offsets(ow, sn)).to(dev)
    # divide tensor by tensor: on CUDA, division by a Python scalar is a
    # multiplication by its rounded reciprocal, not the kernel's division
    bin_h = roi_h / torch.full_like(roi_h, oh)
    bin_w = roi_w / torch.full_like(roi_w, ow)
    ys = y1[:, None] + iy[None, :] * bin_h[:, None]
    xs = x1[:, None] + ix[None, :] * bin_w[:, None]
    return (_bilinear_params(ys, lvl_h[:, None].float()),
            _bilinear_params(xs, lvl_w[:, None].float()), base, lvl_w)


def sample_corners(level_shapes, rois, target_lvls, out_size=(7, 7),
                   featmap_strides=(4, 8, 16, 32), sample_num=2,
                   aligned=True):
    """The bilinear corners of every sample of every RoI.

    ``level_shapes`` are the (B, Hl, Wl) of the levels. Returns the four
    corners (00, 01, 10, 11) as ``(index, weight)`` pairs of shape
    (R, oh*sn, ow*sn), where ``index`` is a row of the levels packed one after
    the other as (sum B*Hl*Wl, C) and ``weight`` is zero for invalid samples,
    and the (R, oh*sn, ow*sn) validity of the samples.
    """
    (y0i, y1i, wy0, wy1, vy), (x0i, x1i, wx0, wx1, vx), lin_base, lvl_w = \
        axis_samples(level_shapes, rois, target_lvls, out_size,
                     featmap_strides, sample_num, aligned)
    valid = vy[:, :, None] & vx[:, None, :]
    validf = valid.float()

    def corner(yi, xi, wy, wx):
        idx = (lin_base[:, None, None] + yi[:, :, None] * lvl_w[:, None, None]
               + xi[:, None, :])
        return idx, wy[:, :, None] * wx[:, None, :] * validf

    return [corner(y0i, x0i, wy0, wx0), corner(y0i, x1i, wy0, wx1),
            corner(y1i, x0i, wy1, wx0), corner(y1i, x1i, wy1, wx1)], valid


def roi_align_pyramid_plain(feats, rois, target_lvls, out_size=(7, 7),
                            featmap_strides=(4, 8, 16, 32), sample_num=2,
                            aligned=True):
    """Plain PyTorch RoIAlign over NHWC levels; the kernel's reference.

    Args:
        feats: list of (B, Hl, Wl, C), one per entry of ``featmap_strides``.
        rois: (R, 5) f32 [batch_idx, x1, y1, x2, y2] in image coordinates.
        target_lvls: (R,) int level of each RoI.
    Returns:
        (R, oh, ow, C) in the feature dtype, computed in f32.
    """
    oh, ow = out_size
    sn = sample_num
    r = rois.shape[0]
    c = feats[0].shape[-1]
    table = torch.cat([f.reshape(-1, c) for f in feats])
    corners, _ = sample_corners([f.shape[:3] for f in feats], rois,
                                target_lvls, out_size, featmap_strides, sn,
                                aligned)
    out = None
    for idx, wgt in corners:
        term = table[idx.reshape(-1)].float().reshape(r, -1, c) \
            * wgt.reshape(r, -1, 1)
        out = term if out is None else out + term
    out = out.reshape(r, oh, sn, ow, sn, c).sum(dim=(2, 4)) / float(sn * sn)
    return out.to(feats[0].dtype)


def roi_align_backward_plain(g, rois, target_lvls, level_shapes,
                             out_size=(7, 7), featmap_strides=(4, 8, 16, 32),
                             sample_num=2, aligned=True):
    """Feature gradient of :func:`roi_align_pyramid_plain`, written out as
    its transpose; the gradient kernel's reference.

    Args:
        g: (R, oh, ow, C) cotangent of the output.
        level_shapes: the (B, Hl, Wl, ...) of each level.
    Returns:
        one (B, Hl, Wl, C) f32 gradient per level: ``g / sn^2`` times each
        corner weight, added with ``index_add_`` into the levels packed as
        (sum B*Hl*Wl, C).
    """
    oh, ow = out_size
    sn = sample_num
    r, c = g.shape[0], g.shape[-1]
    shapes = [tuple(s[:3]) for s in level_shapes]
    corners, _ = sample_corners(shapes, rois, target_lvls, out_size,
                                featmap_strides, sn, aligned)
    # each bin's cotangent, once per sample of the bin, in sample order
    gs = g.float() / torch.full((), float(sn * sn), device=g.device)
    gs = gs.reshape(r, oh, 1, ow, 1, c).expand(r, oh, sn, ow, sn, c) \
        .reshape(-1, c)
    sizes = [b * h * w for b, h, w in shapes]
    table = torch.zeros((sum(sizes), c), dtype=torch.float32,
                        device=g.device)
    for idx, wgt in corners:
        table.index_add_(0, idx.reshape(-1), gs * wgt.reshape(-1, 1))
    return [t.reshape(b, h, w, c)
            for t, (b, h, w) in zip(table.split(sizes), shapes)]


def _lib():
    lib = library('roi_align')
    fn = lib.arfe_roi_align_forward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def roi_align_cuda(feats, rois, target_lvls, out_size=(7, 7),
                   featmap_strides=(4, 8, 16, 32), sample_num=2,
                   aligned=True):
    """Launch the CUDA kernel; arguments as :func:`roi_align_pyramid_plain`.
    Raises ``ValueError`` where the kernel does not apply: channels not a
    multiple of 8 (it reads 16-byte vectors of 8 channels) or a level not
    16-byte aligned."""
    global launches
    dev = rois.device
    num = len(feats)
    if not 1 <= num <= _MAX_LEVELS or num != len(featmap_strides):
        raise ValueError(f'roi_align: {num} levels for '
                         f'{len(featmap_strides)} strides (at most '
                         f'{_MAX_LEVELS})')
    b, _, _, c = feats[0].shape
    dtype = feats[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f'roi_align: feature dtype {dtype} not supported')
    for f in feats:
        if f.device != dev or f.dtype != dtype or f.dim() != 4 \
                or f.shape[0] != b or f.shape[3] != c or not f.is_contiguous():
            raise ValueError('roi_align: levels must be contiguous NHWC '
                             'tensors of one dtype, batch and channel count '
                             'on the RoIs\' CUDA device')
    # the kernel reads 8 channels of a pixel as one 16-byte vector
    if c % 8 or c > 8 * 256 or any(f.data_ptr() % 16 for f in feats):
        raise ValueError(f'roi_align: {c} channels; the kernel takes a '
                         'multiple of 8 up to 2048, in 16-byte aligned '
                         'levels')
    if dev.type != 'cuda' or rois.dtype != torch.float32 or rois.dim() != 2 \
            or rois.shape[1] != 5 or not rois.is_contiguous():
        raise ValueError('roi_align: rois must be a contiguous (R, 5) f32 '
                         'CUDA tensor')
    r = rois.shape[0]
    if target_lvls.device != dev or target_lvls.dtype != torch.int32 \
            or target_lvls.shape != (r,) or not target_lvls.is_contiguous():
        raise ValueError('roi_align: target_lvls must be a contiguous (R,) '
                         'int32 tensor on the RoIs\' device')
    oh, ow = out_size
    out = torch.empty((r, oh, ow, c), dtype=dtype, device=dev)
    ptrs = (ctypes.c_void_p * num)(*[f.data_ptr() for f in feats])
    hs = (ctypes.c_int * num)(*[f.shape[1] for f in feats])
    ws = (ctypes.c_int * num)(*[f.shape[2] for f in feats])
    scales = (ctypes.c_float * num)(*_level_scales(featmap_strides).tolist())
    fn = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(ptrs, hs, ws, scales, num, b, c, rois.data_ptr(),
                 target_lvls.data_ptr(), out.data_ptr(), r, oh, ow,
                 sample_num, int(aligned), _DTYPES[dtype], stream)
    if err:
        raise RuntimeError(f'roi_align kernel launch failed: CUDA error {err}')
    launches += 1
    return out


def _bwd_lib():
    lib = library('roi_align_bwd')
    fn = lib.arfe_roi_align_backward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def roi_align_backward_cuda(g, rois, target_lvls, level_shapes,
                            out_size=(7, 7), featmap_strides=(4, 8, 16, 32),
                            sample_num=2, aligned=True):
    """Launch the gradient kernel; arguments and result as
    :func:`roi_align_backward_plain`, with ``g`` a contiguous f32 CUDA
    tensor. The f32 gradient levels are zero-filled here. Raises
    ``ValueError`` where the kernel does not apply: channels not a multiple
    of 4 up to 1024 (it adds 4 channels of a pixel as one 16-byte vector),
    a cotangent not 16-byte aligned, or more than 128 samples per RoI side
    pair ((out_h + out_w) * sample_num)."""
    global bwd_launches
    dev = rois.device
    num = len(level_shapes)
    if not 1 <= num <= _MAX_LEVELS or num != len(featmap_strides):
        raise ValueError(f'roi_align_backward: {num} levels for '
                         f'{len(featmap_strides)} strides (at most '
                         f'{_MAX_LEVELS})')
    if dev.type != 'cuda' or rois.dtype != torch.float32 or rois.dim() != 2 \
            or rois.shape[1] != 5 or not rois.is_contiguous():
        raise ValueError('roi_align_backward: rois must be a contiguous '
                         '(R, 5) f32 CUDA tensor')
    r = rois.shape[0]
    oh, ow = out_size
    if g.device != dev or g.dtype != torch.float32 or g.dim() != 4 \
            or g.shape[:3] != (r, oh, ow) or not g.is_contiguous():
        raise ValueError(f'roi_align_backward: the cotangent must be a '
                         f'contiguous ({r}, {oh}, {ow}, C) f32 tensor on '
                         'the RoIs\' device')
    if target_lvls.device != dev or target_lvls.dtype != torch.int32 \
            or target_lvls.shape != (r,) or not target_lvls.is_contiguous():
        raise ValueError('roi_align_backward: target_lvls must be a '
                         'contiguous (R,) int32 tensor on the RoIs\' device')
    c = g.shape[3]
    if c % 4 or c > 4 * 256 or g.data_ptr() % 16 \
            or (oh + ow) * sample_num > 128:
        raise ValueError(f'roi_align_backward: {c} channels, {oh}x{ow} bins '
                         f'of {sample_num}^2 samples; the kernel takes a '
                         'multiple of 4 channels up to 1024 in a 16-byte '
                         'aligned cotangent, and (out_h + out_w) * '
                         'sample_num up to 128')
    b = level_shapes[0][0]
    grads = [torch.zeros((b, s[1], s[2], c), dtype=torch.float32, device=dev)
             for s in level_shapes]
    ptrs = (ctypes.c_void_p * num)(*[t.data_ptr() for t in grads])
    hs = (ctypes.c_int * num)(*[t.shape[1] for t in grads])
    ws = (ctypes.c_int * num)(*[t.shape[2] for t in grads])
    scales = (ctypes.c_float * num)(*_level_scales(featmap_strides).tolist())
    fn = _bwd_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(ptrs, hs, ws, scales, num, b, c, g.data_ptr(),
                 rois.data_ptr(), target_lvls.data_ptr(), r, oh, ow,
                 sample_num, int(aligned), stream)
    if err:
        raise RuntimeError(f'roi_align backward kernel launch failed: CUDA '
                           f'error {err}')
    bwd_launches += 1
    return grads


class RoIAlignFunction(torch.autograd.Function):
    """RoIAlign with a gradient for the feature levels only.

    ``apply(rois, target_lvls, out_size, featmap_strides, sample_num,
    aligned, *feats)``. Forward: kernel B on CUDA, the plain version on the
    CPU. Backward: kernel C on CUDA, :func:`roi_align_backward_plain` on the
    CPU, from the f32 cotangent; each level's gradient is returned in that
    level's dtype.
    """

    @staticmethod
    def forward(ctx, rois, target_lvls, out_size, featmap_strides,
                sample_num, aligned, *feats):
        ctx.save_for_backward(rois, target_lvls)
        ctx.args = (out_size, featmap_strides, sample_num, aligned)
        ctx.levels = [(f.shape, f.dtype) for f in feats]
        fn = roi_align_pyramid_plain if rois.device.type == 'cpu' \
            else roi_align_cuda
        return fn(list(feats), rois, target_lvls, *ctx.args)

    @staticmethod
    def backward(ctx, g):
        rois, target_lvls = ctx.saved_tensors
        fn = roi_align_backward_plain if rois.device.type == 'cpu' \
            else roi_align_backward_cuda
        grads = fn(g.float().contiguous(), rois, target_lvls,
                   [shape for shape, _ in ctx.levels], *ctx.args)
        return (None,) * 6 + tuple(
            d.to(dtype) for d, (_, dtype) in zip(grads, ctx.levels))


def roi_align_pyramid(feats, rois, target_lvls, out_size=(7, 7),
                      featmap_strides=(4, 8, 16, 32), sample_num=2,
                      aligned=True):
    """RoIAlign of each RoI on its level ``target_lvls[r]``.

    Runs :class:`RoIAlignFunction`: the kernels on CUDA tensors, the plain
    versions on CPU tensors; gradients reach the levels, not the RoIs.
    ``sample_num <= 0`` means 2.
    """
    if sample_num <= 0:
        sample_num = 2
    return RoIAlignFunction.apply(rois, target_lvls, tuple(out_size),
                                  tuple(featmap_strides), sample_num, aligned,
                                  *feats[:len(featmap_strides)])
