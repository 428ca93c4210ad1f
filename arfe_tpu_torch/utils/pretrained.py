"""Pretrained-backbone initialization (the port's counterpart of
``arfe_tpu/utils/pretrained.py``; ref: mmdet
``pretrained='torchvision://resnet50'``, ResNet.init_weights,
mmdet/models/backbones/resnet.py:634-658, which downloads from the torch
hub).

Nothing is downloaded: ``torchvision://<name>`` resolves to the local file
``$ARFE_PRETRAINED_DIR/<name>.pth`` (default
``~/.cache/arfe_tpu/pretrained/<name>.pth``, the JAX package's), a torch
state_dict placed there. A plain local path (``.pth`` torch state_dict or
the JAX package's converted ``.pkl`` tree) is also accepted. The same
specifications raise the same errors, with the same wording, as in the JAX
package.
"""
from __future__ import annotations

import os

import torch

from ..convert import params_to_state_dict
from .checkpoint import _CheckpointUnpickler

DEFAULT_DIR = os.path.expanduser('~/.cache/arfe_tpu/pretrained')


def _resolve(spec):
    if spec.startswith('torchvision://'):
        name = spec[len('torchvision://'):]
        root = os.environ.get('ARFE_PRETRAINED_DIR', DEFAULT_DIR)
        path = os.path.join(root, name + '.pth')
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"pretrained='{spec}' resolves to {path}, which does not "
                'exist. This environment cannot download weights; place '
                f'the torchvision {name} state_dict there (or set '
                'ARFE_PRETRAINED_DIR), or drop the pretrained= key to '
                'train from scratch.')
        return path
    if spec.startswith(('open_mmlab://', 'http://', 'https://')):
        raise ValueError(
            f"pretrained='{spec}' is not loadable here (no network / no "
            'mmcv model zoo). Convert the checkpoint to a local file and '
            'point pretrained= at it.')
    if not os.path.exists(spec):
        raise FileNotFoundError(f"pretrained file '{spec}' not found")
    return spec


def _backbone_state(path):
    """The checkpoint's backbone tensors by their names under ``backbone.``:
    a torchvision state_dict without its classifier (``fc.*``) and
    BatchNorm counters, or the ``backbone`` subtree of a converted tree."""
    if path.endswith('.pkl'):
        with open(path, 'rb') as f:
            tree = _CheckpointUnpickler(f).load()
        if isinstance(tree, dict) and 'params' in tree:
            tree = tree['params']
        return params_to_state_dict(tree.get('backbone', tree))
    sd = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(sd, dict) and 'state_dict' in sd:
        sd = sd['state_dict']
    out = {}
    for k, v in sd.items():
        if k.startswith('fc.') or k.endswith('num_batches_tracked'):
            continue
        out[k[len('backbone.'):] if k.startswith('backbone.') else k] = v
    return out


def load_pretrained_backbone(spec, model, log=print):
    """Copy the tensors of a pretrained checkpoint into ``model.backbone``
    where name and shape match; log how many matched and which did not.

    Args:
        spec: ``'torchvision://<name>'``, or a local ``.pth`` / ``.pkl``.
        model: a detector with a ``backbone``.
    """
    path = _resolve(spec)
    src = _backbone_state(path)
    dst = model.backbone.state_dict()
    missing, loaded = [], []
    with torch.no_grad():
        for k, v in src.items():
            if k not in dst:
                missing.append(k)
            elif tuple(dst[k].shape) != tuple(v.shape):
                missing.append(f'{k} (shape {tuple(v.shape)} vs '
                               f'{tuple(dst[k].shape)})')
            else:
                dst[k].copy_(v)
                loaded.append(k)
    log(f'pretrained backbone: loaded {len(loaded)} tensors from {path}'
        + (f'; {len(missing)} unmatched ({missing[:5]}...)' if missing
           else ''))
    if not loaded:
        raise ValueError(
            f'pretrained checkpoint {path} matched no backbone params — '
            'wrong architecture or naming?')
    return model
