"""Two-stage bbox heads (counterpart of
``arfe_tpu/models/roi_heads/bbox_heads/bbox_head.py:23-191,194-312``):
``BBoxHead``, ``ConvFCBBoxHead`` and ``Shared2FCBBoxHead``, with the
training targets and losses and the cascade's refinement decode. RoI
features are flattened in torch's (C, H, W) order, so FC weights are the
reference's.
"""
from __future__ import annotations

import torch
from torch import nn

from ....core.post.bbox_nms import multiclass_nms
from ....layers import ConvModule, Linear
from ....registry import BBOX_CODERS, HEADS, LOSSES, build_from_cfg
from ...losses import accuracy


def _flatten_nchw(x):
    """(R, oh, ow, C) RoI features -> (R, C*oh*ow) in (C, H, W) order."""
    if x.dim() == 4:
        return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
    return x.reshape(x.shape[0], -1)


@HEADS.register_module()
class BBoxHead(nn.Module):
    """Optional average pool + cls fc + reg fc."""

    def __init__(self, with_avg_pool=False, with_cls=True, with_reg=True,
                 roi_feat_size=7, in_channels=256, num_classes=80,
                 bbox_coder=None, reg_class_agnostic=False, loss_cls=None,
                 loss_bbox=None):
        super().__init__()
        self.with_avg_pool = with_avg_pool
        self.with_cls = with_cls
        self.with_reg = with_reg
        self.roi_feat_size = roi_feat_size if isinstance(roi_feat_size, tuple)\
            else (roi_feat_size, roi_feat_size)
        self.roi_feat_area = self.roi_feat_size[0] * self.roi_feat_size[1]
        self.in_channels = in_channels
        self.num_classes = num_classes
        self.reg_class_agnostic = reg_class_agnostic
        self.bbox_coder = build_from_cfg(bbox_coder or dict(
            type='DeltaXYWHBBoxCoder', target_means=[0., 0., 0., 0.],
            target_stds=[0.1, 0.1, 0.2, 0.2]), BBOX_CODERS)
        self.loss_cls = build_from_cfg(loss_cls or dict(
            type='CrossEntropyLoss', use_sigmoid=False, loss_weight=1.0),
            LOSSES)
        self.loss_bbox = build_from_cfg(loss_bbox or dict(
            type='SmoothL1Loss', beta=1.0, loss_weight=1.0), LOSSES)
        self._init_layers()

    def _init_layers(self):
        c = self.in_channels
        if not self.with_avg_pool:
            c *= self.roi_feat_area
        self._init_predictors(c, c)

    def _init_predictors(self, cls_in, reg_in):
        if self.with_cls:
            self.fc_cls = Linear(cls_in, self.num_classes + 1,
                                 weight_init='normal', init_std=0.01)
        if self.with_reg:
            out = 4 if self.reg_class_agnostic else 4 * self.num_classes
            self.fc_reg = Linear(reg_in, out, weight_init='normal',
                                 init_std=0.001)

    def _predict(self, x_cls, x_reg):
        cls_score = self.fc_cls(x_cls) if self.with_cls else None
        bbox_pred = self.fc_reg(x_reg) if self.with_reg else None
        return cls_score, bbox_pred

    def forward(self, x):
        """x: (R, oh, ow, C) RoI features -> (cls_score, bbox_pred)."""
        x = x.mean(dim=(1, 2)) if self.with_avg_pool else _flatten_nchw(x)
        return self._predict(x, x)

    def get_bboxes(self, rois, cls_score, bbox_pred, img_shapes,
                   scale_factors, rescale=False, cfg=None, valid_mask=None):
        """Detections of each image.

        Args:
            rois: (B, P, 4) proposal boxes.
            cls_score: (B, P, num_classes + 1); bbox_pred (B, P, 4k) or None.
            img_shapes: (B, 2) (h, w); scale_factors (B, 4).
            valid_mask: (B, P) proposal validity.
        """
        rois = rois.float()
        scores = torch.softmax(cls_score.float(), dim=-1)
        if bbox_pred is not None:
            bboxes = self.bbox_coder.decode(rois, bbox_pred.float(),
                                            max_shape=img_shapes)
        else:
            bboxes = rois
        if rescale:
            k = bboxes.shape[-1] // 4
            bboxes = bboxes / scale_factors[:, None, :4].repeat(1, 1, k)
        return multiclass_nms(bboxes, scores, cfg['score_thr'], cfg['nms'],
                              cfg['max_per_img'],
                              pre_nms_cap=cfg.get('nms_cap', 2000),
                              valid_mask=valid_mask)

    def decoded_boxes_for_refine(self, rois, cls_score, bbox_pred,
                                 img_shapes=None):
        """Each RoI regressed by its predicted class (the argmax of the
        foreground scores), or by the class-agnostic prediction: the next
        cascade stage's boxes (ref: bbox_head.py:245-323,
        ``regress_by_class``).

        Args:
            rois: (B, S, 4); cls_score (B, S, num_classes + 1); bbox_pred
                (B, S, 4) or (B, S, 4 * num_classes).
            img_shapes: optional (B, 2) (h, w) to clamp to.
        Returns:
            (B, S, 4) f32 boxes.
        """
        bbox_pred = bbox_pred.float()
        if not self.reg_class_agnostic:
            labels = cls_score[..., :-1].argmax(dim=-1, keepdim=True)
            inds = 4 * labels + torch.arange(4, device=labels.device)
            bbox_pred = torch.gather(bbox_pred, -1, inds)
        return self.bbox_coder.decode(rois.float(), bbox_pred,
                                      max_shape=img_shapes)

    def get_targets(self, sampled_boxes, sampled_gt_boxes, sampled_labels,
                    is_pos, valid, pos_weight=-1):
        """Targets of the sampled RoIs (..., S): labels (background
        ``num_classes`` where not positive), label_weights (0 on invalid
        slots), bbox_targets (..., S, 4) and bbox_weights (..., S, 4)."""
        labels = torch.where(is_pos, sampled_labels.long(), self.num_classes)
        pw = 1.0 if pos_weight <= 0 else pos_weight
        label_weights = torch.where(valid, torch.where(is_pos, pw, 1.0), 0.0)
        targets = self.bbox_coder.encode(sampled_boxes, sampled_gt_boxes)
        bbox_targets = torch.where(is_pos[..., None], targets, 0.0)
        bbox_weights = is_pos[..., None].expand(targets.shape).float()
        return labels, label_weights, bbox_targets, bbox_weights

    def loss(self, cls_score, bbox_pred, labels, label_weights, bbox_targets,
             bbox_weights):
        """``loss_cls``, ``acc`` (over the weighted slots) and ``loss_bbox``
        (averaged over all slots) of inputs flattened over the batch."""
        losses = {}
        if cls_score is not None:
            cls_score = cls_score.float()
            avg_factor = torch.clamp(label_weights.sum(), min=1.0)
            losses['loss_cls'] = self.loss_cls(cls_score, labels,
                                               label_weights,
                                               avg_factor=avg_factor)
            losses['acc'] = accuracy(cls_score, labels,
                                     valid_mask=label_weights > 0)
        if bbox_pred is not None:
            pred = bbox_pred.float()
            if not self.reg_class_agnostic:
                safe = torch.clamp(labels, 0, self.num_classes - 1)
                inds = 4 * safe[:, None] + torch.arange(4,
                                                        device=safe.device)
                pred = torch.gather(pred, 1, inds)
            losses['loss_bbox'] = self.loss_bbox(
                pred, bbox_targets, bbox_weights,
                avg_factor=float(bbox_targets.shape[0]))
        return losses


@HEADS.register_module()
class ConvFCBBoxHead(BBoxHead):
    """Shared convs / fcs, then separate cls and reg convs / fcs."""

    def __init__(self, num_shared_convs=0, num_shared_fcs=0, num_cls_convs=0,
                 num_cls_fcs=0, num_reg_convs=0, num_reg_fcs=0,
                 conv_out_channels=256, fc_out_channels=1024, norm_cfg=None,
                 **kwargs):
        self.num_shared_convs = num_shared_convs
        self.num_shared_fcs = num_shared_fcs
        self.num_cls_convs = num_cls_convs
        self.num_cls_fcs = num_cls_fcs
        self.num_reg_convs = num_reg_convs
        self.num_reg_fcs = num_reg_fcs
        self.conv_out_channels = conv_out_channels
        self.fc_out_channels = fc_out_channels
        self.norm_cfg = norm_cfg
        super().__init__(**kwargs)

    def _branch(self, num_convs, num_fcs, in_channels, is_shared=False):
        convs, fcs = nn.ModuleList(), nn.ModuleList()
        last = in_channels
        for _ in range(num_convs):
            convs.append(ConvModule(last, self.conv_out_channels, 3,
                                    padding=1, norm_cfg=self.norm_cfg,
                                    act_cfg='relu', weight_init='xavier'))
            last = self.conv_out_channels
        if num_fcs > 0:
            if (is_shared or num_convs == 0) and not self.with_avg_pool:
                last *= self.roi_feat_area
            for _ in range(num_fcs):
                fcs.append(Linear(last, self.fc_out_channels,
                                  weight_init='xavier'))
                last = self.fc_out_channels
        return convs, fcs, last

    def _init_layers(self):
        self.shared_convs, self.shared_fcs, last = self._branch(
            self.num_shared_convs, self.num_shared_fcs, self.in_channels,
            is_shared=True)
        self.cls_convs, self.cls_fcs, cls_last = self._branch(
            self.num_cls_convs, self.num_cls_fcs, last)
        self.reg_convs, self.reg_fcs, reg_last = self._branch(
            self.num_reg_convs, self.num_reg_fcs, last)
        if self.num_shared_fcs == 0 and not self.with_avg_pool:
            if self.num_cls_fcs == 0:
                cls_last *= self.roi_feat_area
            if self.num_reg_fcs == 0:
                reg_last *= self.roi_feat_area
        self._init_predictors(cls_last, reg_last)

    @staticmethod
    def _convs(convs, x):
        """NHWC RoI features through NCHW convs, back to NHWC."""
        if len(convs) == 0:
            return x
        x = x.permute(0, 3, 1, 2)
        for m in convs:
            x = m(x)
        return x.permute(0, 2, 3, 1)

    def _branch_forward(self, x, convs, fcs):
        x = self._convs(convs, x)
        if x.dim() > 2:
            x = x.mean(dim=(1, 2)) if self.with_avg_pool else _flatten_nchw(x)
        for m in fcs:
            x = torch.relu(m(x))
        return x

    def forward(self, x):
        x = self._convs(self.shared_convs, x)
        if self.num_shared_fcs > 0:
            x = _flatten_nchw(x)
            for m in self.shared_fcs:
                x = torch.relu(m(x))
        return self._predict(
            self._branch_forward(x, self.cls_convs, self.cls_fcs),
            self._branch_forward(x, self.reg_convs, self.reg_fcs))


@HEADS.register_module()
class Shared2FCBBoxHead(ConvFCBBoxHead):
    def __init__(self, fc_out_channels=1024, **kwargs):
        super().__init__(num_shared_convs=0, num_shared_fcs=2,
                         num_cls_convs=0, num_cls_fcs=0, num_reg_convs=0,
                         num_reg_fcs=0, fc_out_channels=fc_out_channels,
                         **kwargs)
