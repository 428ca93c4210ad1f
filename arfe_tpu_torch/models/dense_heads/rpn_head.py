"""RPN head: proposals and training loss (counterpart of
``arfe_tpu/models/dense_heads/rpn_head.py:20-50,71-109,156-302``).

The loss reads the 1x1 cls / reg outputs of the shared features in the
(anchor, position) candidate order of the proposals, with the anchor table
in the same order, and returns ``loss_rpn_cls`` / ``loss_rpn_bbox``.

Proposals, per level: shared 3x3 conv + relu, 1x1 cls / reg convs read
channel-major,
so candidates are in (anchor, position) order; top ``nms_pre`` by logit
(stable sort: ties keep that order, as ``jax.lax.top_k`` does); decode,
clamp to the image, min-size filter; NMS per (image, level), which with
level-keyed suppression is the reference's batched NMS; then the top
``nms_post`` kept boxes of the image. The TPU-only ``approx_topk`` key is
ignored.
"""
from __future__ import annotations

import torch

from ...core.bbox.coder import delta2bbox
from ...layers import Conv2d
from ...ops.nms import nms_batched
from ...registry import HEADS
from .anchor_head import AnchorHead, stable_topk


@HEADS.register_module()
class RPNHead(AnchorHead):
    anchor_major = True

    def __init__(self, in_channels, **kwargs):
        super().__init__(1, in_channels, background_label=0, **kwargs)

    def _init_layers(self):
        self.rpn_conv = Conv2d(self.in_channels, self.feat_channels, 3,
                               padding=1, weight_init='normal', init_std=0.01)
        self.rpn_cls = Conv2d(self.feat_channels,
                              self.num_anchors * self.cls_out_channels, 1,
                              weight_init='normal', init_std=0.01)
        self.rpn_reg = Conv2d(self.feat_channels, self.num_anchors * 4, 1,
                              weight_init='normal', init_std=0.01)

    def shared_single(self, x):
        return torch.relu(self.rpn_conv(x))

    def _heads(self, shared):
        """The 1x1 cls / reg outputs of a shared feature (B, C, H, W), in
        f32, as (B, A, co, H*W) and (B, A, 4, H*W)."""
        b, _, h, w = shared.shape
        num_a = self.num_anchors
        return (self.rpn_cls(shared).float().reshape(b, num_a, -1, h * w),
                self.rpn_reg(shared).float().reshape(b, num_a, 4, h * w))

    def loss_from_shared(self, shared, gt_bboxes, gt_valid, img_shapes, gen):
        """RPN losses from the per-level shared features (B, C, H, W).

        Args:
            gt_bboxes: (B, G, 4) padded; gt_valid (B, G); img_shapes (B, 2).
            gen: the ``torch.Generator`` of the sampler's priorities.
        """
        featmap_sizes = [tuple(x.shape[2:]) for x in shared]
        anchors, flags = self._flat_anchor_table(featmap_sizes,
                                                 shared[0].device)
        cls_l, box_l = [], []
        for x in shared:
            cls_t, reg_t = self._heads(x)
            b = x.shape[0]
            cls_l.append(cls_t.transpose(2, 3).reshape(
                b, -1, self.cls_out_channels))
            box_l.append(reg_t.transpose(2, 3).reshape(b, -1, 4))
        losses = self._loss_from_flat(
            anchors, flags, torch.cat(cls_l, 1), torch.cat(box_l, 1),
            gt_bboxes, gt_valid, None, img_shapes, gen)
        return dict(loss_rpn_cls=losses['loss_cls'],
                    loss_rpn_bbox=losses['loss_bbox'])

    def get_proposals(self, feats, img_shapes, cfg=None, shared=None):
        """Proposals of each image.

        Args:
            feats: per-level (B, C, H, W) features.
            img_shapes: (B, 2) f32 (h, w) of the image content.
            shared: optional per-level ``shared_single`` outputs, computed
                here from ``feats`` when not given.
        Returns:
            proposals (B, nms_post, 5) [x1, y1, x2, y2, score] padded with
            [0, 0, 0, 0, -1], and their (B, nms_post) validity.
        """
        cfg = self.test_cfg if cfg is None else cfg
        if shared is None:
            shared = [self.shared_single(x) for x in feats]
        mlvl_anchors = self.anchor_generator.grid_anchors(
            [tuple(x.shape[2:]) for x in shared])
        nms_pre = cfg.get('nms_pre', -1)
        num_a = self.num_anchors
        scores_l, preds_l, anchors_l = [], [], []
        for x, anchors in zip(shared, mlvl_anchors):
            b, _, h, w = x.shape
            hw = h * w
            cls_t, reg_t = self._heads(x)
            if self.use_sigmoid_cls:
                logits = cls_t.reshape(b, num_a * hw)
            else:
                # softmax fg prob of a (fg, bg) pair == sigmoid(l0 - l1)
                lt = cls_t.reshape(b, num_a, 2, hw)
                logits = (lt[:, :, 0] - lt[:, :, 1]).reshape(b, num_a * hw)
            preds = reg_t.transpose(1, 2).reshape(b, 4, num_a * hw)
            anchors = torch.from_numpy(
                anchors.reshape(hw, num_a, 4).transpose(1, 0, 2)
                .reshape(num_a * hw, 4)).to(x.device)
            hwa = num_a * hw
            if 0 < nms_pre < hwa:
                lg, idx = stable_topk(logits, nms_pre)
                prd = torch.gather(preds, 2, idx[:, None, :].expand(
                    b, 4, nms_pre)).transpose(1, 2)
                anc = anchors[idx]
            else:
                lg, prd = logits, preds.transpose(1, 2)
                anc = anchors.expand(b, hwa, 4)
            scores_l.append(torch.sigmoid(lg))
            preds_l.append(prd)
            anchors_l.append(anc)
        return self._finish_proposals(scores_l, preds_l, anchors_l,
                                      img_shapes, cfg)

    def _finish_proposals(self, scores_l, preds_l, anchors_l, img_shapes,
                          cfg):
        nms_post = cfg.get('nms_post', cfg.get('max_num', 1000))
        counts = [s.shape[1] for s in scores_l]
        k_cap = max(counts)
        b = scores_l[0].shape[0]
        num_lvls = len(scores_l)

        def pad_to(x, fill=0.0):
            pad = k_cap - x.shape[1]
            if pad == 0:
                return x
            return torch.cat([x, x.new_full((b, pad) + x.shape[2:], fill)], 1)

        scores = torch.stack([pad_to(s, -1.0) for s in scores_l], 1)
        preds = torch.stack([pad_to(p) for p in preds_l], 1)
        anchors = torch.stack([pad_to(a) for a in anchors_l], 1)
        ar = torch.arange(k_cap, device=scores.device)
        lvl_valid = torch.stack([ar < c for c in counts])[None].expand(
            b, num_lvls, k_cap)
        proposals = delta2bbox(anchors, preds, self.bbox_coder.means,
                               self.bbox_coder.stds,
                               max_shape=img_shapes[:, None, :])
        min_size = cfg.get('min_bbox_size', 0)
        w = proposals[..., 2] - proposals[..., 0]
        h = proposals[..., 3] - proposals[..., 1]
        valid = (w >= min_size) & (h >= min_size) & lvl_valid

        dets, _, kept = nms_batched(
            proposals.reshape(b * num_lvls, k_cap, 4),
            scores.reshape(b * num_lvls, k_cap), cfg['nms_thr'],
            max_out=k_cap, valid_mask=valid.reshape(b * num_lvls, k_cap))
        dets = dets.reshape(b, num_lvls * k_cap, 5)
        kept = kept.reshape(b, num_lvls * k_cap)
        kept_scores = torch.where(kept, dets[..., 4], float('-inf'))
        k_out = min(nms_post, num_lvls * k_cap)
        top_vals, top_idx = stable_topk(kept_scores, k_out)
        dets = torch.gather(dets, 1, top_idx[..., None].expand(b, k_out, 5))
        out_valid = torch.isfinite(top_vals)
        pad_row = dets.new_tensor([0., 0., 0., 0., -1.])
        dets = torch.where(out_valid[..., None], dets, pad_row)
        if k_out < nms_post:
            pad = nms_post - k_out
            dets = torch.cat([dets, pad_row.expand(b, pad, 5)], 1)
            out_valid = torch.cat([out_valid, out_valid.new_zeros(b, pad)], 1)
        return dets, out_valid
