"""Anchor-based dense head base (counterpart of
``arfe_tpu/models/dense_heads/anchor_head.py:25-84,367-515``): box coder,
anchor generator, losses and classification channels from the config, and
with a ``train_cfg`` the assigner, the sampler and the anchor targets and
losses of the training step, batched over the images."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...registry import (ANCHOR_GENERATORS, BBOX_ASSIGNERS, BBOX_CODERS,
                         BBOX_SAMPLERS, LOSSES, build_from_cfg)


def anchor_inside_flags(flat_anchors, valid_flags, img_shapes,
                        allowed_border=0):
    """(B, N) flags of the (N, 4) anchors that are valid and, unless
    ``allowed_border`` is negative, lie inside each image's (h, w) of
    ``img_shapes`` (B, 2) by that border."""
    b = img_shapes.shape[0]
    if allowed_border < 0:
        return valid_flags.expand(b, -1)
    h, w = img_shapes[:, 0:1], img_shapes[:, 1:2]
    inside = ((flat_anchors[:, 0] >= -allowed_border)
              & (flat_anchors[:, 1] >= -allowed_border)
              & (flat_anchors[:, 2] < w + allowed_border)
              & (flat_anchors[:, 3] < h + allowed_border))
    return valid_flags & inside


class AnchorHead(nn.Module):
    def __init__(self, num_classes, in_channels, feat_channels=256,
                 anchor_generator=None, bbox_coder=None, background_label=None,
                 loss_cls=None, loss_bbox=None, train_cfg=None,
                 test_cfg=None):
        super().__init__()
        self.num_classes = num_classes
        self.in_channels = in_channels
        self.feat_channels = feat_channels
        loss_cls = loss_cls or dict(type='CrossEntropyLoss', use_sigmoid=True,
                                    loss_weight=1.0)
        loss_bbox = loss_bbox or dict(type='SmoothL1Loss', beta=1.0 / 9.0,
                                      loss_weight=1.0)
        self.use_sigmoid_cls = loss_cls.get('use_sigmoid', False)
        self.cls_out_channels = (num_classes if self.use_sigmoid_cls
                                 else num_classes + 1)
        # the background label is num_classes (mmdet v2.0)
        self.background_label = (num_classes if background_label is None
                                 else background_label)
        self.loss_cls = build_from_cfg(loss_cls, LOSSES)
        self.loss_bbox = build_from_cfg(loss_bbox, LOSSES)
        self.bbox_coder = build_from_cfg(
            bbox_coder or dict(type='DeltaXYWHBBoxCoder'), BBOX_CODERS)
        self.anchor_generator = build_from_cfg(
            anchor_generator or dict(type='AnchorGenerator',
                                     scales=[8, 16, 32],
                                     ratios=[0.5, 1.0, 2.0],
                                     strides=[4, 8, 16, 32, 64]),
            ANCHOR_GENERATORS)
        self.num_anchors = self.anchor_generator.num_base_anchors[0]
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        if train_cfg is not None:
            if loss_cls.get('type') in ('FocalLoss', 'GHMC',
                                        'QualityFocalLoss'):
                raise NotImplementedError('training without sampling is '
                                          'not ported')
            self.assigner = build_from_cfg(train_cfg['assigner'],
                                           BBOX_ASSIGNERS)
            self.sampler = build_from_cfg(train_cfg['sampler'], BBOX_SAMPLERS)
        self._init_layers()

    def _init_layers(self):
        raise NotImplementedError

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def _flat_anchor_table(self, featmap_sizes, device):
        """All levels' anchors (N, 4) and pad-shape valid flags (N,), each
        level in (anchor, position) order: the order of the channel-major
        head outputs and of the proposals, not the reference's (position,
        anchor); the loss does not depend on it."""
        mlvl_anchors = self.anchor_generator.grid_anchors(featmap_sizes)
        stride = self.anchor_generator.strides[0]
        pad_shape = (featmap_sizes[0][0] * stride[0],
                     featmap_sizes[0][1] * stride[1])
        mlvl_flags = self.anchor_generator.valid_flags(featmap_sizes,
                                                       pad_shape)
        num_a = self.num_anchors
        anchors = [a.reshape(-1, num_a, 4).transpose(1, 0, 2).reshape(-1, 4)
                   for a in mlvl_anchors]
        flags = [f.reshape(-1, num_a).T.reshape(-1) for f in mlvl_flags]
        return (torch.from_numpy(np.concatenate(anchors)).to(device),
                torch.from_numpy(np.concatenate(flags)).to(device))

    def _targets(self, gen, anchors, flags, gt_bboxes, gt_valid, gt_labels,
                 img_shapes):
        """Anchor targets of every image: labels (B, N), label_weights
        (B, N), bbox_targets (B, N, 4), bbox_weights (B, N, 4) and the
        numbers of sampled positives and negatives (B,)."""
        inside = anchor_inside_flags(anchors, flags, img_shapes,
                                     self.train_cfg.get('allowed_border', 0))
        assigned = self.assigner.assign(anchors, gt_bboxes, gt_valid,
                                        box_valid=inside)['assigned_gt_inds']
        sample = self.sampler.sample(gen, assigned)

        safe_gt = torch.clamp(assigned - 1, 0, gt_bboxes.shape[1] - 1)
        matched_gt = torch.gather(gt_bboxes.float(), 1,
                                  safe_gt[..., None].expand(-1, -1, 4))
        all_targets = self.bbox_coder.encode(anchors, matched_gt)
        if gt_labels is None:
            all_labels = torch.ones_like(assigned)   # the RPN's foreground
        else:
            all_labels = torch.gather(gt_labels.long(), 1, safe_gt)

        inds, valid = sample['inds'], sample['valid']

        def selected(mask):
            sel = torch.zeros_like(assigned)
            return sel.scatter_reduce_(1, inds, mask.long(), 'amax') > 0

        pos_sel = selected(sample['is_pos'] & valid)
        neg_sel = selected(~sample['is_pos'] & valid)
        pos_w = self.train_cfg.get('pos_weight', -1)
        pos_w = 1.0 if pos_w <= 0 else pos_w
        labels = torch.where(pos_sel, all_labels, self.background_label)
        label_weights = torch.where(
            neg_sel, 1.0, torch.where(pos_sel, pos_w, 0.0))
        bbox_targets = torch.where(pos_sel[..., None], all_targets, 0.0)
        bbox_weights = pos_sel[..., None].expand(-1, -1, 4).float()
        return (labels, label_weights, bbox_targets, bbox_weights,
                pos_sel.sum(-1), neg_sel.sum(-1))

    def _loss_from_flat(self, anchors, flags, cls_flat, box_flat, gt_bboxes,
                        gt_valid, gt_labels, img_shapes, gen):
        """Classification and box losses over the flat outputs cls_flat
        (B, N, co) and box_flat (B, N, 4), in the order of ``anchors``."""
        labels, label_weights, bbox_targets, bbox_weights, npos, nneg = \
            self._targets(gen, anchors, flags, gt_bboxes, gt_valid,
                          gt_labels, img_shapes)
        num_total_samples = (torch.clamp(npos, min=1).sum()
                             + torch.clamp(nneg, min=1).sum()).float()
        co = self.cls_out_channels
        cls_flat = cls_flat.reshape(-1, co)
        labels = labels.reshape(-1)
        label_weights = label_weights.reshape(-1)
        if self.use_sigmoid_cls and co == 1:
            # the RPN: 0/1 labels against one logit per anchor
            loss_cls = self.loss_cls(cls_flat[:, 0], labels.float(),
                                     label_weights,
                                     avg_factor=num_total_samples)
        else:
            loss_cls = self.loss_cls(cls_flat, labels, label_weights,
                                     avg_factor=num_total_samples)
        loss_bbox = self.loss_bbox(box_flat.reshape(-1, 4),
                                   bbox_targets.reshape(-1, 4),
                                   bbox_weights.reshape(-1, 4),
                                   avg_factor=num_total_samples)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)
