"""Detector construction and single-image inference (counterpart of
``arfe_tpu/apis/inference.py:37-118``).

:func:`init_detector` returns the detector ``nn.Module`` itself, in eval
mode on its device, with the config at ``.cfg`` and the class names at
``.CLASSES``: a PyTorch module already bundles its parameters, which the JAX
package's ``Detector`` holds beside a stateless model. Serve it with
``simple_test`` on preprocessed NHWC images, or with
:func:`inference_detector` on an image file or a BGR array.
"""
from __future__ import annotations

import torch

from ..config import Config
from ..core.bbox import bbox2result
from ..core.evaluation import get_classes
from ..data.builder import collate_test
from ..data.pipelines import Compose
from ..layers import init_weights
from ..models import build_detector
from ..utils.checkpoint import load_checkpoint


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
        checkpoint: optional weights, loaded with ``strict=True``: the JAX
            package's native ``.pkl`` (read without JAX,
            ``utils.checkpoint``) or an mmdet-style ``.pth``. Without one
            the weights are random, drawn from a ``torch.Generator`` seeded
            with 0.
        device: ``None`` means ``'cuda'``, which raises where there is no
            card; tests pass ``'cpu'``.
        train: build the heads with the config's ``train_cfg`` (assigners,
            samplers), for ``forward_train`` and ``train.make_train_step``.

    ``model.CLASSES`` comes from the checkpoint's ``meta``, else it is
    COCO's.
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
    classes = None
    if checkpoint is None:
        init_weights(model, torch.Generator().manual_seed(0))
    else:
        if str(checkpoint).endswith('.pkl'):
            state, meta = load_checkpoint(checkpoint)
            classes = meta.get('CLASSES')
        else:
            state = load_state_dict_file(checkpoint)
        model.load_state_dict(state, strict=True)
    model.CLASSES = classes if classes is not None else get_classes('coco')
    model.cfg = config
    model.eval()
    model.to(device)
    if device.type == 'cuda':
        model.to(memory_format=torch.channels_last)
    return model


def build_test_pipeline(cfg):
    """The config's ``data.test.pipeline`` with ``LoadImage`` first, which
    takes a path or a BGR array (ref: apis/inference.py:64-69)."""
    pipeline = [dict(p) for p in cfg.todict()['data']['test']['pipeline']]
    if pipeline[0]['type'] not in ('LoadImageFromFile', 'LoadImage'):
        raise ValueError('the test pipeline must start by loading the image')
    pipeline[0] = dict(type='LoadImage')
    return Compose(pipeline)


def num_classes(model):
    return model.roi_head.bbox_head.num_classes


def detections_to_results(dets, labels, valid, n_classes):
    """``simple_test``'s outputs of a batch -> per image, ``n_classes``
    float32 arrays of shape (k, 5) [x1, y1, x2, y2, score]."""
    dets, labels, valid = (t.float().cpu().numpy() if t.is_floating_point()
                           else t.cpu().numpy() for t in (dets, labels, valid))
    dets[~valid] = -1.0
    return [bbox2result(d, lab, n_classes) for d, lab in zip(dets, labels)]


def batch_to_device(batch, device, dtype=torch.float32):
    """The loader's ``img`` (in ``dtype``), ``img_shape`` and
    ``scale_factor`` on ``device``."""
    return (batch['img'].to(device, dtype), batch['img_shape'].to(device),
            batch['scale_factor'].to(device))


def inference_detector(model, img, dtype=torch.float32):
    """Detect objects in one image (ref: apis/inference.py:68-107).

    Args:
        model: from :func:`init_detector`, with a config that has
            ``data.test.pipeline``.
        img: a path, or a BGR uint8 (H, W, 3) array as OpenCV reads it.
        dtype: the image's dtype on the model's device (f32 or bf16).
    Returns:
        ``num_classes`` float32 arrays of shape (k, 5) [x1, y1, x2, y2,
        score], in the original image's coordinates. Masks come with Mask
        R-CNN (ROADMAP §1).
    """
    batch = collate_test([build_test_pipeline(model.cfg)(dict(img=img))])
    device = next(model.parameters()).device
    out = model.simple_test(*batch_to_device(batch, device, dtype),
                            rescale=True)
    return detections_to_results(*out, num_classes(model))[0]
