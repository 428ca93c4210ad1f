"""Single-stage detectors: inference and training losses (counterpart of
``arfe_tpu/models/detectors/single_stage.py:16-77,151-153``): backbone,
necks and a dense head that detects from every level's anchors. RetinaNet.

The JAX package's channel-major head path (``ARFE_TPU_CM_FINALS``, with its
optimisation barrier) is a TPU layout workaround and is not ported, nor is
test-time augmentation (``aug_test``).
"""
from __future__ import annotations

import torch
from torch import nn

from ...registry import DETECTORS
from ..builder import build_backbone, build_head, build_neck


@DETECTORS.register_module()
class SingleStageDetector(nn.Module):
    def __init__(self, backbone, neck=None, bbox_head=None, train_cfg=None,
                 test_cfg=None, pretrained=None):
        super().__init__()
        self.train_cfg = train_cfg or {}
        self.test_cfg = test_cfg or {}
        self.backbone = build_backbone(backbone)
        self.neck = build_neck(neck) if neck is not None else None
        self.bbox_head = build_head(dict(bbox_head, train_cfg=train_cfg,
                                         test_cfg=test_cfg))

    # what the tools ask of a detector, whatever its family
    with_mask = with_multi_cls = False
    num_extractions = 0
    roi_samplers = ()

    @property
    def dense_head(self):
        """The head that holds the anchors."""
        return self.bbox_head

    @property
    def num_classes(self):
        return self.bbox_head.num_classes

    def classifiers(self):
        """The layers that give the class logits."""
        return self.bbox_head.classifiers()

    def extract_feat(self, img):
        """NHWC images (B, H, W, 3) -> per-level NCHW features."""
        x = self.backbone(img.permute(0, 3, 1, 2))
        return x if self.neck is None else self.neck(x)

    def forward_train(self, img, img_shapes, gt_bboxes, gt_valid, gt_labels,
                      gen, gt_mask_crops=None):
        """Training losses of a batch: ``loss_cls`` and ``loss_bbox``.

        Args:
            img: (B, H, W, 3) images, f32 or bf16, on the model's device.
            img_shapes: (B, 2) f32 (h, w) of each image's content.
            gt_bboxes: (B, G, 4) f32 padded; gt_valid (B, G) bool;
                gt_labels (B, G) int.
            gen: ``torch.Generator`` on the model's device, for sampling.
            gt_mask_crops: accepted so that the trainer calls every
                detector alike; unused.
        """
        outs = self.bbox_head(self.extract_feat(img))
        return self.bbox_head.loss(*outs, gt_bboxes, gt_valid, gt_labels,
                                   img_shapes, gen)

    @torch.inference_mode()
    def simple_test(self, img, img_shapes, scale_factors, rescale=False):
        """Batched inference.

        Args:
            img: (B, H, W, 3) images, f32 or bf16, on the model's device.
            img_shapes: (B, 2) f32 (h, w) of each image's content.
            scale_factors: (B, 4) f32 resize factors (used with ``rescale``).
        Returns:
            dets (B, max_per_img, 5) padded with [0, 0, 0, 0, -1], labels
            (B, max_per_img) int32, valid (B, max_per_img) bool.
        """
        outs = self.bbox_head(self.extract_feat(img))
        return self.bbox_head.get_bboxes(*outs, img_shapes, scale_factors,
                                         rescale=rescale)


@DETECTORS.register_module()
class RetinaNet(SingleStageDetector):
    """ref: mmdet/models/detectors/retinanet.py"""
