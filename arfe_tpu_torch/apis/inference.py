"""Detector construction and single-image inference (counterpart of
``arfe_tpu/apis/inference.py:37-118``).

:func:`init_detector` returns the detector ``nn.Module`` itself, in eval
mode on its device, with the config at ``.cfg`` and the class names at
``.CLASSES``: a PyTorch module already bundles its parameters, which the JAX
package's ``Detector`` holds beside a stateless model. Serve it with
``simple_test`` on preprocessed NHWC images, or with
:func:`inference_detector` on an image file or a BGR array; a Mask R-CNN's
masks are pasted into the original image on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..core.bbox import bbox2result
from ..core.evaluation import get_classes
from ..core.mask.mask_target import paste_masks_np
from ..data.builder import collate_test
from ..data.pipelines import Compose
from ..layers import init_weights
from ..models import build_detector
from ..utils.checkpoint import load_checkpoint


def init_detector(config, checkpoint=None, device=None, train=False):
    """Build a detector from a config (path or :class:`Config`).

    Args:
        checkpoint: optional weights, loaded with ``strict=True``: the JAX
            package's native ``.pkl`` (read without JAX), the port's or an
            mmdet-style ``.pth`` (``utils.checkpoint``). Without one
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
        state, meta, _, _ = load_checkpoint(checkpoint)
        classes = meta.get('CLASSES')
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


def detections_to_results(out, n_classes, ori_shapes=None):
    """``simple_test``'s outputs of a batch -> per image, ``n_classes``
    float32 arrays of shape (k, 5) [x1, y1, x2, y2, score]; for a mask
    model (mask logits in ``out``) per image the pair ``(bbox, segm)``,
    ``segm`` holding per class the (H, W) uint8 masks of its detections,
    in their order: each detection's sigmoid mask pasted into its image's
    original (H, W) of ``ori_shapes`` and thresholded at 0.5."""
    dets, labels, valid = (t.float().cpu().numpy() if t.is_floating_point()
                           else t.cpu().numpy() for t in out[:3])
    dets[~valid] = -1.0
    bboxes = [bbox2result(d, lab, n_classes) for d, lab in zip(dets, labels)]
    if len(out) == 3:
        return bboxes
    logits = out[3].float().cpu().numpy()
    probs = 1.0 / (1.0 + np.exp(-logits))   # the JAX package's sigmoid
    results = []
    for d, lab, prob, bbox, shape in zip(dets, labels, probs, bboxes,
                                         ori_shapes):
        keep = d[:, 4] > -1
        pasted = paste_masks_np(prob[keep], d[keep], *shape[:2])
        lab = lab[keep]
        results.append((bbox, [list(pasted[lab == c])
                               for c in range(n_classes)]))
    return results


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
        score], in the original image's coordinates; for a mask model the
        pair ``(bbox, segm)``, ``segm`` holding per class the (H, W) uint8
        masks of its detections in the original image.
    """
    batch = collate_test([build_test_pipeline(model.cfg)(dict(img=img))])
    device = next(model.parameters()).device
    out = model.simple_test(*batch_to_device(batch, device, dtype),
                            rescale=True)
    return detections_to_results(
        out, model.num_classes,
        [m['ori_shape'] for m in batch['img_metas']])[0]
