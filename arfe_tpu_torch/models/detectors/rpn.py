"""The region proposal network on its own (counterpart of
``arfe_tpu/models/detectors/two_stage.py:190-250``; ref:
mmdet/models/detectors/rpn.py): backbone, necks (none in the C4 form, whose
one stride-16 level the head reads) and an ``RPNHead``. Training is
class-agnostic; a request returns the proposals, which
``CocoDataset.evaluate`` scores by their recall (``proposal_fast``)."""
from __future__ import annotations

import torch
from torch import nn

from ...registry import DETECTORS
from ..builder import build_backbone, build_head, build_neck


@DETECTORS.register_module()
class RPN(nn.Module):
    def __init__(self, backbone, neck=None, rpn_head=None, train_cfg=None,
                 test_cfg=None, pretrained=None, roi_head=None):
        super().__init__()
        if roi_head is not None:
            raise ValueError('RPN: a detector with a RoI head is two-stage')
        self.train_cfg = train_cfg or {}
        self.test_cfg = test_cfg or {}
        self.backbone = build_backbone(backbone)
        self.neck = build_neck(neck) if neck is not None else None
        self.rpn_head = build_head(dict(
            rpn_head, train_cfg=self.train_cfg.get('rpn'),
            test_cfg=self.test_cfg.get('rpn')))

    # what the tools ask of a detector, whatever its family
    with_mask = with_multi_cls = serves_masks = False
    num_extractions = num_step_extractions = 0
    roi_samplers = ()

    @property
    def dense_head(self):
        """The head that holds the anchors."""
        return self.rpn_head

    @property
    def num_classes(self):
        return self.rpn_head.num_classes

    def classifiers(self):
        """The layers that give the objectness logits."""
        return [self.rpn_head.rpn_cls]

    def extract_feat(self, img):
        """NHWC images (B, H, W, 3) -> per-level NCHW features."""
        x = self.backbone(img.permute(0, 3, 1, 2))
        return x if self.neck is None else self.neck(x)

    def forward_train(self, img, img_shapes, gt_bboxes, gt_valid, gt_labels,
                      gen, gt_mask_crops=None):
        """``loss_rpn_cls`` and ``loss_rpn_bbox`` of a batch; ``gt_labels``
        and ``gt_mask_crops`` are accepted so that the trainer calls every
        detector alike, and unused (the RPN is class-agnostic).

        Args:
            img: (B, H, W, 3) images, f32 or bf16, on the model's device.
            img_shapes: (B, 2) f32 (h, w) of each image's content.
            gt_bboxes: (B, G, 4) f32 padded; gt_valid (B, G) bool.
            gen: ``torch.Generator`` on the model's device, for sampling.
        """
        shared = [self.rpn_head.shared_single(f)
                  for f in self.extract_feat(img)]
        return self.rpn_head.loss_from_shared(shared, gt_bboxes, gt_valid,
                                              img_shapes, gen)

    @torch.inference_mode()
    def simple_test(self, img, img_shapes, scale_factors, rescale=False):
        """The proposals of a batch.

        Args:
            img: (B, H, W, 3) images, f32 or bf16, on the model's device.
            img_shapes: (B, 2) f32 (h, w) of each image's content.
            scale_factors: (B, 4) f32 resize factors (used with ``rescale``).
        Returns:
            proposals (B, nms_post, 5) [x1, y1, x2, y2, score] padded with
            [0, 0, 0, 0, -1] (with ``rescale`` in the original image's
            scale), and their (B, nms_post) validity.
        """
        props, valid = self.rpn_head.get_proposals(self.extract_feat(img),
                                                   img_shapes)
        if rescale:
            props = torch.cat([props[..., :4] / scale_factors[:, None, :4],
                               props[..., 4:]], -1)
        return props, valid
