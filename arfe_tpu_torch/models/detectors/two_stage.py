"""Two-stage detectors: inference and training losses (counterpart of
``arfe_tpu/models/detectors/two_stage.py:11-121,155-161,170-172``): Faster
R-CNN, Mask R-CNN, whose RoI head has a mask branch, and Cascade R-CNN,
whose RoI head refines in stages (``train_cfg['rcnn']`` a list, one entry
per stage)."""
from __future__ import annotations

import torch
from torch import nn

from ...registry import DETECTORS
from ..builder import build_backbone, build_head, build_neck


@DETECTORS.register_module()
class TwoStageDetector(nn.Module):
    def __init__(self, backbone, neck=None, rpn_head=None, roi_head=None,
                 train_cfg=None, test_cfg=None, pretrained=None):
        super().__init__()
        self.train_cfg = train_cfg or {}
        self.test_cfg = test_cfg or {}
        self.backbone = build_backbone(backbone)
        self.neck = build_neck(neck) if neck is not None else None
        if rpn_head is None:
            raise NotImplementedError('detectors without an RPN head take '
                                      'external proposals: not ported')
        self.rpn_head = build_head(dict(
            rpn_head, train_cfg=self.train_cfg.get('rpn'),
            test_cfg=self.test_cfg.get('rpn')))
        self.roi_head = build_head(dict(
            roi_head, train_cfg=self.train_cfg.get('rcnn'),
            test_cfg=self.test_cfg.get('rcnn')))

    # what the tools ask of a detector, whatever its family
    @property
    def dense_head(self):
        """The head that holds the anchors."""
        return self.rpn_head

    @property
    def num_classes(self):
        return self.roi_head.num_classes

    @property
    def with_mask(self):
        return self.roi_head.with_mask

    @property
    def with_multi_cls(self):
        return self.roi_head.with_multi_cls

    @property
    def num_extractions(self):
        """RoIAlign calls in one request, and in one step."""
        return self.roi_head.num_extractions

    @property
    def roi_samplers(self):
        """The RoI head's samplers, in stage order."""
        return self.roi_head.stage_samplers

    def classifiers(self):
        """The layers that give the class logits."""
        return self.roi_head.classifiers()

    def extract_feat(self, img):
        """NHWC images (B, H, W, 3) -> per-level NCHW features."""
        x = self.backbone(img.permute(0, 3, 1, 2))
        return x if self.neck is None else self.neck(x)

    def forward_train(self, img, img_shapes, gt_bboxes, gt_valid, gt_labels,
                      gen, gt_mask_crops=None):
        """Training losses of a batch.

        Args:
            img: (B, H, W, 3) images, f32 or bf16, on the model's device.
            img_shapes: (B, 2) f32 (h, w) of each image's content.
            gt_bboxes: (B, G, 4) f32 padded; gt_valid (B, G) bool;
                gt_labels (B, G) int.
            gen: ``torch.Generator`` on the model's device, for sampling.
            gt_mask_crops: (B, G, cs, cs) f32 gt mask crops, for a mask
                head (``data.builder.collate_train``).
        Returns:
            dict of ``loss_rpn_cls``, ``loss_rpn_bbox``, ``loss_cls``,
            ``acc`` and ``loss_bbox``, and ``loss_mask`` with a mask head.
        """
        x = self.extract_feat(img)
        shared = [self.rpn_head.shared_single(f) for f in x]
        losses = self.rpn_head.loss_from_shared(shared, gt_bboxes, gt_valid,
                                                img_shapes, gen)
        # proposals from the detached shared features, as the JAX package
        # computes them: the 1x1 heads' weights stay in the graph, so the RoI
        # head's box targets send a gradient through the decoded proposals
        # into rpn_reg (the RoI extraction gives the RoIs none)
        props, prop_valid = self.rpn_head.get_proposals(
            x, img_shapes,
            cfg=self.train_cfg.get('rpn_proposal')
            or self.test_cfg.get('rpn'),
            shared=[s.detach() for s in shared])
        losses.update(self.roi_head.forward_train(
            x, props, prop_valid, gt_bboxes, gt_valid, gt_labels, gen,
            gt_mask_crops=gt_mask_crops, img_shapes=img_shapes))
        return losses

    @torch.inference_mode()
    def simple_test(self, img, img_shapes, scale_factors, rescale=False):
        """Batched inference.

        Args:
            img: (B, H, W, 3) images, f32 or bf16, on the model's device.
            img_shapes: (B, 2) f32 (h, w) of each image's content.
            scale_factors: (B, 4) f32 resize factors (used with ``rescale``).
        Returns:
            dets (B, max_per_img, 5) padded with [0, 0, 0, 0, -1], labels
            (B, max_per_img) int32, valid (B, max_per_img) bool; with a
            mask head also each slot's mask logits (B, max_per_img, 28, 28).
        """
        x = self.extract_feat(img)
        props, prop_valid = self.rpn_head.get_proposals(x, img_shapes)
        return self.roi_head.simple_test(x, props, prop_valid, img_shapes,
                                         scale_factors, rescale=rescale)


@DETECTORS.register_module()
class FasterRCNN(TwoStageDetector):
    """ref: mmdet/models/detectors/faster_rcnn.py"""


@DETECTORS.register_module()
class MaskRCNN(TwoStageDetector):
    """ref: mmdet/models/detectors/mask_rcnn.py"""


@DETECTORS.register_module()
class CascadeRCNN(TwoStageDetector):
    """ref: mmdet/models/detectors/cascade_rcnn.py"""
