"""Data pipeline transforms, on the host in numpy (counterpart of
``arfe_tpu/data/pipelines.py:20-523``).

Transforms take and return mmdet-style ``results`` dicts, so the reference's
pipeline configs load unchanged, and give the JAX package's arrays bit for
bit: images are read and resized by ``image_io`` in place of OpenCV. The
test-time transforms are complete. ``LoadAnnotations`` and
``DefaultFormatBundle`` load from a training config, and their bodies come
with the training run (ROADMAP §1). Test-time augmentation
(``MultiScaleFlipAug`` over several scales or with flips) is queued with
``aug_test``.
"""
from __future__ import annotations

import os.path as osp

import numpy as np

from ..registry import PIPELINES, build_from_cfg
from .image_io import imread, imresize


class Compose:
    """(ref: pipelines/compose.py:9)."""

    def __init__(self, transforms):
        self.transforms = []
        for t in transforms:
            if isinstance(t, dict):
                self.transforms.append(build_from_cfg(t, PIPELINES))
            elif callable(t):
                self.transforms.append(t)
            else:
                raise TypeError('transform must be callable or a dict')

    def __call__(self, results):
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results


def _loaded(results, img):
    results['img'] = img
    results['img_shape'] = img.shape
    results['ori_shape'] = img.shape
    results['img_fields'] = ['img']
    return results


@PIPELINES.register_module()
class LoadImageFromFile:
    """(ref: pipelines/loading.py:12-60). Loads BGR uint8, as OpenCV does;
    only ``color_type='color'`` is read."""

    def __init__(self, to_float32=False, color_type='color'):
        if color_type != 'color':
            raise NotImplementedError(
                f'LoadImageFromFile: color_type={color_type!r} is not read')
        self.to_float32 = to_float32

    def __call__(self, results):
        if results.get('img_prefix') is not None:
            filename = osp.join(results['img_prefix'],
                                results['img_info']['filename'])
        else:
            filename = results['img_info']['filename']
        img = imread(filename)
        if self.to_float32:
            img = img.astype(np.float32)
        results['filename'] = filename
        results['ori_filename'] = results['img_info']['filename']
        return _loaded(results, img)


@PIPELINES.register_module()
class LoadImage:
    """A path or a BGR ndarray in ``results['img']`` (ref:
    apis/inference.py:51-66)."""

    def __call__(self, results):
        img = results['img']
        if isinstance(img, str):
            results['filename'] = results['ori_filename'] = img
            img = imread(img)
        else:
            results['filename'] = results['ori_filename'] = None
        return _loaded(results, img)


@PIPELINES.register_module()
class LoadAnnotations:
    """(ref: pipelines/loading.py:153-283). Loads from a config; the body
    comes with the training run."""

    def __init__(self, with_bbox=True, with_label=True, with_mask=False,
                 with_seg=False, poly2mask=True):
        pass

    def __call__(self, results):
        raise NotImplementedError(
            'LoadAnnotations: the train pipeline is ported with the '
            'training run (ROADMAP §1)')


def _rescale_size(old_size, scale):
    """mmcv rescale semantics: scale=(long, short) max constraint."""
    w, h = old_size
    if isinstance(scale, (int, float)):
        scale_factor = scale
    else:
        max_long, max_short = max(scale), min(scale)
        scale_factor = min(max_long / max(h, w), max_short / min(h, w))
    new_w = int(w * scale_factor + 0.5)
    new_h = int(h * scale_factor + 0.5)
    return (new_w, new_h), scale_factor


@PIPELINES.register_module()
class Resize:
    """(ref: pipelines/transforms.py:25-190): value/range multiscale and
    keep_ratio; boxes in ``bbox_fields`` scaled and clipped."""

    def __init__(self, img_scale=None, multiscale_mode='range',
                 ratio_range=None, keep_ratio=True):
        if img_scale is None:
            self.img_scale = None
        elif isinstance(img_scale, list):
            self.img_scale = [tuple(s) for s in img_scale]
        else:
            self.img_scale = [tuple(img_scale)]
        if multiscale_mode not in ('value', 'range'):
            raise ValueError(f'multiscale_mode {multiscale_mode!r}')
        self.multiscale_mode = multiscale_mode
        self.ratio_range = ratio_range
        self.keep_ratio = keep_ratio

    def _random_scale(self, results):
        if self.ratio_range is not None:
            scale = self.img_scale[0]
            ratio = np.random.uniform(*self.ratio_range)
            scale = (int(scale[0] * ratio), int(scale[1] * ratio))
        elif len(self.img_scale) == 1:
            scale = self.img_scale[0]
        elif self.multiscale_mode == 'range':
            longs = [max(s) for s in self.img_scale]
            shorts = [min(s) for s in self.img_scale]
            long_edge = np.random.randint(min(longs), max(longs) + 1)
            short_edge = np.random.randint(min(shorts), max(shorts) + 1)
            scale = (long_edge, short_edge)
        else:  # value
            scale = self.img_scale[np.random.randint(len(self.img_scale))]
        results['scale'] = scale

    def __call__(self, results):
        if 'scale' not in results:
            self._random_scale(results)
        if results.get('mask_fields'):
            raise NotImplementedError('Resize: masks come with Mask R-CNN '
                                      '(ROADMAP §1)')
        img = results['img']
        h, w = img.shape[:2]
        if self.keep_ratio:
            (new_w, new_h), _ = _rescale_size((w, h), results['scale'])
        else:
            new_w, new_h = results['scale']
        resized = imresize(img, (new_w, new_h))
        w_scale = new_w / w
        h_scale = new_h / h
        results['img'] = resized
        results['img_shape'] = resized.shape
        results['pad_shape'] = resized.shape
        results['scale_factor'] = np.array(
            [w_scale, h_scale, w_scale, h_scale], dtype=np.float32)
        results['keep_ratio'] = self.keep_ratio
        for key in results.get('bbox_fields', []):
            bboxes = results[key] * results['scale_factor']
            bboxes[:, 0::2] = np.clip(bboxes[:, 0::2], 0, new_w)
            bboxes[:, 1::2] = np.clip(bboxes[:, 1::2], 0, new_h)
            results[key] = bboxes
        return results


@PIPELINES.register_module()
class RandomFlip:
    """(ref: pipelines/transforms.py:192-260): image and ``bbox_fields``."""

    def __init__(self, flip_ratio=None, direction='horizontal'):
        self.flip_ratio = flip_ratio
        self.direction = direction

    def __call__(self, results):
        if 'flip' not in results:
            results['flip'] = (self.flip_ratio is not None
                               and np.random.rand() < self.flip_ratio)
        if 'flip_direction' not in results:
            results['flip_direction'] = self.direction
        if results['flip']:
            if results.get('mask_fields'):
                raise NotImplementedError('RandomFlip: masks come with Mask '
                                          'R-CNN (ROADMAP §1)')
            horizontal = results['flip_direction'] == 'horizontal'
            results['img'] = np.flip(results['img'],
                                     axis=1 if horizontal else 0).copy()
            h, w = results['img'].shape[:2]
            for key in results.get('bbox_fields', []):
                bboxes = results[key].copy()
                if horizontal:
                    bboxes[:, 0::4] = w - results[key][:, 2::4]
                    bboxes[:, 2::4] = w - results[key][:, 0::4]
                else:
                    bboxes[:, 1::4] = h - results[key][:, 3::4]
                    bboxes[:, 3::4] = h - results[key][:, 1::4]
                results[key] = bboxes
        return results


@PIPELINES.register_module()
class Normalize:
    """(ref: pipelines/transforms.py:319-347)."""

    def __init__(self, mean, std, to_rgb=True):
        self.mean = np.array(mean, dtype=np.float32)
        self.std = np.array(std, dtype=np.float32)
        self.to_rgb = to_rgb

    def __call__(self, results):
        img = results['img'].astype(np.float32)
        if self.to_rgb:
            img = img[..., ::-1]
        results['img'] = (img - self.mean) / self.std
        results['img_norm_cfg'] = dict(mean=self.mean, std=self.std,
                                       to_rgb=self.to_rgb)
        return results


@PIPELINES.register_module()
class Pad:
    """(ref: pipelines/transforms.py:262-317): pads bottom and right to
    ``size`` or to a multiple of ``size_divisor``."""

    def __init__(self, size=None, size_divisor=None, pad_val=0):
        if (size is None) == (size_divisor is None):
            raise ValueError('Pad takes one of size and size_divisor')
        self.size = size
        self.size_divisor = size_divisor
        self.pad_val = pad_val

    def __call__(self, results):
        img = results['img']
        h, w = img.shape[:2]
        if self.size is not None:
            th, tw = self.size
        else:
            d = self.size_divisor
            th, tw = -(-h // d) * d, -(-w // d) * d
        padded = np.full((th, tw) + img.shape[2:], self.pad_val,
                         dtype=img.dtype)
        padded[:h, :w] = img
        results['img'] = padded
        results['pad_shape'] = padded.shape
        results['pad_fixed_size'] = self.size
        results['pad_size_divisor'] = self.size_divisor
        return results


@PIPELINES.register_module()
class DefaultFormatBundle:
    """(ref: pipelines/formating.py:101-140). Loads from a config; the body
    comes with the training run."""

    def __call__(self, results):
        raise NotImplementedError(
            'DefaultFormatBundle: the train pipeline is ported with the '
            'training run (ROADMAP §1)')


@PIPELINES.register_module()
class ImageToTensor:
    """Test-path formatting (ref: formating.py): images stay HWC float32
    numpy; the loader's collate makes the batch tensor."""

    def __init__(self, keys=('img',)):
        self.keys = keys

    def __call__(self, results):
        for key in self.keys:
            results[key] = np.ascontiguousarray(
                results[key].astype(np.float32))
        return results


@PIPELINES.register_module()
class Collect:
    """(ref: pipelines/formating.py:141-189)."""

    DEFAULT_META = ('filename', 'ori_filename', 'ori_shape', 'img_shape',
                    'pad_shape', 'scale_factor', 'flip', 'flip_direction',
                    'img_norm_cfg')

    def __init__(self, keys, meta_keys=DEFAULT_META):
        self.keys = keys
        self.meta_keys = meta_keys

    def __call__(self, results):
        data = {'img_metas': {k: results.get(k) for k in self.meta_keys}}
        for key in self.keys:
            data[key] = results[key]
        return data


@PIPELINES.register_module()
class MultiScaleFlipAug:
    """(ref: pipelines/test_aug.py:8-78), at one scale without flips: the
    output is a dict of one-element lists, as the JAX package's. More scales
    or flips are test-time augmentation, queued with ``aug_test`` (ROADMAP
    §1)."""

    def __init__(self, transforms, img_scale, flip=False,
                 flip_direction='horizontal'):
        scales = img_scale if isinstance(img_scale, list) else [img_scale]
        if len(scales) != 1 or flip:
            raise NotImplementedError(
                'MultiScaleFlipAug: test-time augmentation (several scales '
                'or flips) is not ported yet')
        self.transforms = Compose(transforms)
        self.img_scale = tuple(scales[0])

    def __call__(self, results):
        results = dict(results, scale=self.img_scale, flip=False,
                       flip_direction=None)
        return {k: [v] for k, v in self.transforms(results).items()}
