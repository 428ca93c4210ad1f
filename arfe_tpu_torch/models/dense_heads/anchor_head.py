"""Anchor-based dense head base (counterpart of
``arfe_tpu/models/dense_heads/anchor_head.py:37-136,182-258,367-515``): box
coder, anchor generator, losses and classification channels from the config;
with a ``train_cfg`` the assigner, the sampler (a ``PseudoSampler`` for the
losses that need no sampling, such as the focal loss) and the anchor targets
and losses of the training step; and the single-stage detections
(``get_bboxes``), all batched over the images.

Candidates are in the reference's (position, anchor) order: a level's
(B, A * C, H, W) output read as (B, H * W * A, C). The RPN reads its 1x1
heads channel-major, in (anchor, position) order, and builds its anchor table
to match (``anchor_major``). The JAX package's TPU layout paths (the slice
gather of ``_topk_level_nhwc``, the channel-major finals) are not ported: a
flatten and a top-k make the same selection.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...core.post.bbox_nms import multiclass_nms
from ...registry import (ANCHOR_GENERATORS, BBOX_ASSIGNERS, BBOX_CODERS,
                         BBOX_SAMPLERS, LOSSES, build_from_cfg)

#: classification losses trained on every anchor, without sampling
UNSAMPLED_LOSSES = ('FocalLoss', 'GHMC', 'QualityFocalLoss')


def stable_topk(x, k):
    """The k largest of each row, ties in index order (jax.lax.top_k)."""
    neg, idx = torch.sort(-x, dim=-1, stable=True)
    return -neg[..., :k], idx[..., :k]


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
        self.sampling = loss_cls.get('type') not in UNSAMPLED_LOSSES
        if train_cfg is not None:
            self.assigner = build_from_cfg(train_cfg['assigner'],
                                           BBOX_ASSIGNERS)
            self.sampler = build_from_cfg(
                train_cfg['sampler'] if self.sampling
                else dict(type='PseudoSampler'), BBOX_SAMPLERS)
        self._init_layers()

    def _init_layers(self):
        raise NotImplementedError

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    #: candidates in (anchor, position) order (the RPN's channel-major
    #: outputs), not (position, anchor)
    anchor_major = False

    def _flat_anchor_table(self, featmap_sizes, device):
        """All levels' anchors (N, 4) and pad-shape valid flags (N,), each
        level in the head's candidate order (``anchor_major``); the loss
        does not depend on the order."""
        mlvl_anchors = self.anchor_generator.grid_anchors(featmap_sizes)
        stride = self.anchor_generator.strides[0]
        pad_shape = (featmap_sizes[0][0] * stride[0],
                     featmap_sizes[0][1] * stride[1])
        mlvl_flags = self.anchor_generator.valid_flags(featmap_sizes,
                                                       pad_shape)
        if self.anchor_major:
            num_a = self.num_anchors
            mlvl_anchors = [a.reshape(-1, num_a, 4).transpose(1, 0, 2)
                            .reshape(-1, 4) for a in mlvl_anchors]
            mlvl_flags = [f.reshape(-1, num_a).T.reshape(-1)
                          for f in mlvl_flags]
        return (torch.from_numpy(np.concatenate(mlvl_anchors)).to(device),
                torch.from_numpy(np.concatenate(mlvl_flags)).to(device))

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
        num_total_samples = torch.clamp(npos, min=1).sum().float()
        if self.sampling:
            num_total_samples = num_total_samples \
                + torch.clamp(nneg, min=1).sum()
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

    # ------------------------------------------------------------------
    # the single-stage head: outputs, losses and detections
    # ------------------------------------------------------------------

    def forward(self, feats):
        """Per-level (B, A * co, H, W) class logits and (B, A * 4, H, W)
        regressions of ``forward_single``."""
        outs = [self.forward_single(x) for x in feats]
        return [o[0] for o in outs], [o[1] for o in outs]

    def _flatten(self, cls_scores, bbox_preds):
        """Per-level outputs -> f32 (B, N, co) and (B, N, 4) in (position,
        anchor) order (``force_fp32`` in the reference)."""
        b, co = cls_scores[0].shape[0], self.cls_out_channels
        return (torch.cat([s.float().permute(0, 2, 3, 1).reshape(b, -1, co)
                           for s in cls_scores], 1),
                torch.cat([p.float().permute(0, 2, 3, 1).reshape(b, -1, 4)
                           for p in bbox_preds], 1))

    def loss(self, cls_scores, bbox_preds, gt_bboxes, gt_valid, gt_labels,
             img_shapes, gen):
        """``loss_cls`` and ``loss_bbox`` over every level's anchors.

        Args:
            cls_scores / bbox_preds: per-level outputs of :meth:`forward`.
            gt_bboxes: (B, G, 4) padded; gt_valid (B, G); gt_labels (B, G).
            img_shapes: (B, 2); gen: the sampler's ``torch.Generator``.
        """
        featmap_sizes = [tuple(s.shape[2:]) for s in cls_scores]
        anchors, flags = self._flat_anchor_table(featmap_sizes,
                                                 cls_scores[0].device)
        cls_flat, box_flat = self._flatten(cls_scores, bbox_preds)
        return self._loss_from_flat(anchors, flags, cls_flat, box_flat,
                                    gt_bboxes, gt_valid, gt_labels,
                                    img_shapes, gen)

    def get_bboxes(self, cls_scores, bbox_preds, img_shapes, scale_factors,
                   cfg=None, rescale=False):
        """Detections of each image: per level the ``nms_pre`` candidates of
        largest class score (stable: ties in candidate order, as
        ``jax.lax.top_k``), decoded and clamped to the image, with
        ``rescale`` mapped back to the original image, then
        ``multiclass_nms`` (ref: anchor_head.py:420-553).

        Args:
            cls_scores / bbox_preds: per-level outputs of :meth:`forward`.
            img_shapes: (B, 2) (h, w) of the content; scale_factors (B, 4).
        Returns:
            dets (B, max_per_img, 5), labels (B, max_per_img) int32, valid
            (B, max_per_img) bool.
        """
        cfg = self.test_cfg if cfg is None else cfg
        featmap_sizes = [tuple(s.shape[2:]) for s in cls_scores]
        mlvl_anchors = self.anchor_generator.grid_anchors(featmap_sizes)
        nms_pre = cfg.get('nms_pre', -1)
        probs_l, preds_l, anchors_l = [], [], []
        for cls_score, bbox_pred, anchors in zip(cls_scores, bbox_preds,
                                                 mlvl_anchors):
            scores, preds = self._flatten([cls_score], [bbox_pred])
            b, n = scores.shape[:2]
            anchors = torch.from_numpy(anchors).to(scores.device)
            if self.use_sigmoid_cls:
                # the sigmoid is monotone: that of the largest logit
                rank = torch.sigmoid(scores.amax(dim=-1))
            else:
                rank = torch.softmax(scores, dim=-1)[..., :-1].amax(dim=-1)
            if 0 < nms_pre < n:
                idx = stable_topk(rank, nms_pre)[1]
                scores = torch.gather(scores, 1, idx[..., None].expand(
                    b, nms_pre, scores.shape[-1]))
                preds = torch.gather(preds, 1,
                                     idx[..., None].expand(b, nms_pre, 4))
                anchors = anchors[idx]
            else:
                anchors = anchors.expand(b, n, 4)
            probs_l.append(torch.sigmoid(scores) if self.use_sigmoid_cls
                           else torch.softmax(scores, dim=-1))
            preds_l.append(preds)
            anchors_l.append(anchors)
        probs = torch.cat(probs_l, 1)
        bboxes = self.bbox_coder.decode(torch.cat(anchors_l, 1),
                                        torch.cat(preds_l, 1),
                                        max_shape=img_shapes)
        if rescale:
            bboxes = bboxes / scale_factors[:, None, :4]
        if self.use_sigmoid_cls:
            # the background column multiclass_nms ignores
            probs = torch.cat([probs, probs.new_zeros(probs.shape[:-1]
                                                      + (1,))], -1)
        return multiclass_nms(bboxes, probs, cfg['score_thr'], cfg['nms'],
                              cfg['max_per_img'],
                              pre_nms_cap=cfg.get('nms_cap', 2000))
