"""Detector construction for serving and training (counterpart of
``arfe_tpu/apis/inference.py:37-61``).

:func:`init_detector` returns the detector ``nn.Module`` itself, in eval
mode on its device, with the config at ``.cfg``: a PyTorch module already
bundles its parameters, which the JAX package's ``Detector`` holds beside a
stateless model. Serve it with ``simple_test`` on preprocessed NHWC images.
"""
from __future__ import annotations

import torch

from ..config import Config
from ..layers import init_weights
from ..models import build_detector


def load_state_dict_file(path):
    """An mmdet-style checkpoint (``{'state_dict': ..., 'meta': ...}`` or a
    bare state_dict) as a state_dict: ``module.`` prefixes stripped and
    ``num_batches_tracked`` counters (frozen BatchNorm keeps none) dropped."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    state = ckpt.get('state_dict', ckpt)
    return {(k[7:] if k.startswith('module.') else k): v
            for k, v in state.items()
            if not k.endswith('num_batches_tracked')}


def init_detector(config, checkpoint=None, device=None, train=False):
    """Build a detector from a config (path or :class:`Config`).

    Args:
        checkpoint: optional ``.pth`` state_dict, loaded with ``strict=True``;
            without one the weights are random, drawn from a
            ``torch.Generator`` seeded with 0.
        device: ``None`` means ``'cuda'``, which raises where there is no
            card; tests pass ``'cpu'``.
        train: build the heads with the config's ``train_cfg`` (assigners,
            samplers), for ``forward_train`` and ``train.make_train_step``.
    """
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('init_detector: no CUDA device (pass '
                           'device="cpu" to run the plain PyTorch path)')
    if isinstance(config, str):
        config = Config.fromfile(config)
    cfg = config.todict()
    model_cfg = dict(cfg['model'])
    model_cfg.pop('pretrained', None)
    model = build_detector(model_cfg,
                           train_cfg=cfg.get('train_cfg') if train else None,
                           test_cfg=cfg.get('test_cfg'))
    if checkpoint is not None:
        model.load_state_dict(load_state_dict_file(checkpoint), strict=True)
    else:
        init_weights(model, torch.Generator().manual_seed(0))
    model.cfg = config
    model.eval()
    model.to(device)
    if device.type == 'cuda':
        model.to(memory_format=torch.channels_last)
    return model
