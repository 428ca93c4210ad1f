"""FSAF head (counterpart of ``arfe_tpu/models/dense_heads/fsaf_head.py:
25-192``; ref: mmdet/models/dense_heads/fsaf_head.py).

A RetinaNet head on one square anchor a position, trained anchor-free with
online feature selection: the ``CenterRegionAssigner`` makes each gt's
positives on every level, each level's mean loss over a gt's positives
decides the gt's level, and only there do its positives keep their losses.
The box branch predicts top / bottom / left / right distances
(``TBLRBBoxCoder``), kept positive by a ReLU and by ``retina_reg``'s bias of
0.25, and trained on decoded boxes (``reg_decoded_bbox``, the IoU loss).
The running count of gts a level takes, which the reference writes to
``gt_assign.txt`` from inside the loss, is returned as ``gt_assign_hist``
(not a loss) for the training loop to add up and write.
"""
from __future__ import annotations

import torch

from ...layers import Conv2d
from ...registry import HEADS
from .anchor_head import anchor_inside_flags
from .retina_head import RetinaHead


def _one_hot(labels, n):
    """A bool one-hot of ``labels`` over ``n`` columns; out-of-range labels
    (the background, padding) give an all-false row."""
    return labels[..., None] == torch.arange(n, device=labels.device)


@HEADS.register_module()
class FSAFHead(RetinaHead):
    def __init__(self, num_classes, in_channels, stacked_convs=4,
                 anchor_generator=None, **kwargs):
        kwargs.setdefault('reg_decoded_bbox', True)
        kwargs.setdefault('bbox_coder', dict(type='TBLRBBoxCoder',
                                             normalizer=4.0))
        super().__init__(num_classes, in_channels,
                         stacked_convs=stacked_convs,
                         anchor_generator=anchor_generator or dict(
                             type='AnchorGenerator', octave_base_scale=1,
                             scales_per_octave=1, ratios=[1.0],
                             strides=[8, 16, 32, 64, 128]),
                         **kwargs)

    def _init_layers(self):
        super()._init_layers()
        # a positive bias keeps the predicted boxes from zero area
        self.retina_reg = Conv2d(self.feat_channels, self.num_anchors * 4, 3,
                                 padding=1, weight_init='normal',
                                 init_std=0.01, bias_value=0.25)

    def forward_single(self, x):
        cls_score, bbox_pred = super().forward_single(x)
        # the coder takes positive distances only
        return cls_score, torch.relu(bbox_pred)

    def _fsaf_targets(self, anchors, flags, gt_bboxes, gt_valid, gt_labels,
                      img_shapes):
        """Targets of every image: labels (B, N), label_weights (B, N, C),
        bbox_targets (B, N, 4), bbox_weights (B, N), pos_gt_inds (B, N)
        (the positive's gt, -1 elsewhere) and the number of negatives."""
        g = gt_bboxes.shape[1]
        c = self.cls_out_channels
        inside = anchor_inside_flags(anchors, flags, img_shapes,
                                     self.train_cfg.get('allowed_border', -1))
        res = self.assigner.assign(anchors, gt_bboxes, gt_valid, gt_labels,
                                   box_valid=inside)
        assigned = res['assigned_gt_inds']
        gt_labels = gt_labels.long()
        # the (anchor, class) pairs a gt's shadow covers
        shadow_cls = torch.einsum('bng,bgc->bnc',
                                  res['shadowed_mat'].float(),
                                  _one_hot(gt_labels, c).float()) > 0
        pos = assigned > 0
        safe = torch.clamp(assigned - 1, 0, g - 1)
        labels_pos = torch.gather(gt_labels, 1, safe)
        # a positive shadowed for its own class is no positive
        own_shadow = torch.gather(
            shadow_cls, 2, torch.clamp(labels_pos, 0, c - 1)[..., None]
        )[..., 0] & pos
        pos = pos & ~own_shadow
        assigned = torch.where(own_shadow, 0, assigned)

        labels = torch.where(pos, labels_pos, self.background_label)
        pos_w = self.train_cfg.get('pos_weight', -1)
        pos_w = 1.0 if pos_w <= 0 else pos_w
        lw_row = torch.where(pos, pos_w, torch.where(assigned == 0, 1.0, 0.0))
        label_weights = torch.where(shadow_cls, 0.0, lw_row[..., None])
        matched = torch.gather(gt_bboxes.float(), 1,
                               safe[..., None].expand(-1, -1, 4))
        bbox_targets = torch.where(pos[..., None], matched, 0.0)
        pos_gt_inds = torch.where(pos, safe, -1)
        return (labels, label_weights, bbox_targets, pos.float(), pos_gt_inds,
                (assigned == 0).sum())

    def loss(self, cls_scores, bbox_preds, gt_bboxes, gt_valid, gt_labels,
             img_shapes, gen=None):
        """``loss_cls``, ``loss_bbox``, the positives an image ``num_pos``,
        their ``accuracy`` and ``gt_assign_hist`` (L,): how many valid gts
        chose each level.

        Args:
            cls_scores / bbox_preds: per-level outputs of :meth:`forward`.
            gt_bboxes: (B, G, 4) padded; gt_valid (B, G); gt_labels (B, G).
            img_shapes: (B, 2); gen: unused (nothing is sampled).
        """
        b, c = cls_scores[0].shape[0], self.cls_out_channels
        g = gt_bboxes.shape[1]
        featmap_sizes = [tuple(s.shape[2:]) for s in cls_scores]
        anchors, flags = self._flat_anchor_table(featmap_sizes,
                                                 cls_scores[0].device)
        # no zero-area predicted boxes
        cls_flat, box_flat = self._flatten(
            cls_scores, [torch.clamp(p.float(), min=1e-4) for p in bbox_preds])
        labels, label_weights, bbox_targets, bbox_weights, pos_gt_inds, \
            num_neg = self._fsaf_targets(anchors, flags, gt_bboxes, gt_valid,
                                         gt_labels, img_shapes)

        cls_el = self.loss_cls(cls_flat.reshape(-1, c), labels.reshape(-1),
                               label_weights.reshape(-1, c),
                               reduction_override='none').reshape(b, -1, c)
        decoded = self.bbox_coder.decode(anchors, box_flat)
        reg_el = self.loss_bbox(decoded.reshape(-1, 4),
                                bbox_targets.reshape(-1, 4),
                                bbox_weights.reshape(-1),
                                reduction_override='none').reshape(b, -1)

        # each gt's mean loss over its positives on each level; its level
        # is the least
        loss_anchor = cls_el.sum(-1) + reg_el                   # (B, N)
        ow = _one_hot(pos_gt_inds, g).float()                   # (B, N, G)
        lvl_losses, level_of_anchor, start = [], [], 0
        for i, (h, w) in enumerate(featmap_sizes):
            n = h * w * self.num_anchors
            cnt = ow[:, start:start + n].sum(1)                 # (B, G)
            tot = torch.einsum('bng,bn->bg', ow[:, start:start + n],
                               loss_anchor[:, start:start + n])
            lvl_losses.append(torch.where(
                cnt > 0, tot / torch.clamp(cnt, min=1), 1e6))
            level_of_anchor.append(torch.full((n,), i,
                                              device=ow.device))
            start += n
        min_levels = torch.stack(lvl_losses, 1).argmin(dim=1).detach()
        level_of_anchor = torch.cat(level_of_anchor)

        # positives keep their losses at their gt's level only; a dropped
        # one loses its own class's channel and its box loss
        chosen = torch.gather(min_levels, 1, torch.clamp(pos_gt_inds, 0,
                                                         g - 1))
        keep = (pos_gt_inds >= 0) & (chosen == level_of_anchor)
        dropped = (pos_gt_inds >= 0) & ~keep
        cls_el = torch.where(dropped[..., None] & _one_hot(labels, c), 0.0,
                             cls_el)
        reg_el = torch.where(dropped, 0.0, reg_el)

        num_pos = keep.sum().float()
        avg_factor = torch.where(num_pos > 0, num_pos,
                                 num_pos + num_neg.float())
        correct = ((cls_flat.argmax(-1) == labels) & keep).sum().float()
        hist = (_one_hot(min_levels, len(featmap_sizes)).float()
                * gt_valid[..., None]).sum((0, 1))
        return dict(loss_cls=cls_el.sum() / avg_factor,
                    loss_bbox=reg_el.sum() / avg_factor,
                    num_pos=num_pos / b,
                    accuracy=correct / torch.clamp(num_pos, min=1e-3),
                    gt_assign_hist=hist.detach())
