"""Standard RoI head, bbox and mask branches (counterpart of
``arfe_tpu/models/roi_heads/standard_roi_head.py:20-341,420-447``):
proposals in as (B, P, 5) with a validity mask. Inference gives detections
with fixed capacity, and with a mask head each detection slot's mask
logits; training assigns and samples every image's candidates into ``num``
fixed slots and returns the bbox losses, and with a mask head the mask
loss of the positive slots.

With ``multi_rois`` (AR-RFF; on by default for a head with
``num_roi_groups == 3``) each RoI is extracted three times, as itself and
stretched by ``get_adaptive_scale_rois``, in one RoIAlign call over the 3R
RoIs, each on the level of its own box, and the three blocks are
concatenated channel-wise as [ori, lw, lh]. A head with ``with_multi_cls``
("+fac") also returns per-image presence logits, trained against the
classes of each image's sampled RoIs.

The mask branch (Mask R-CNN) extracts its RoIs with its own extractor (14 x
14 bins; the bbox one where the config gives none): in training the
leading ``num * pos_fraction`` slots of each image, which hold every
positive (the sampler packs them first), against targets resampled from
the batch's fixed gt crops (``core.mask.mask_target_from_crops``); in
inference every detection slot, padding included, so each request makes
one mask extraction of fixed size. Mask test-time augmentation is not
ported here.

With a ``shared_head`` (the C4 detectors' ``ResLayer``, counterpart of
``standard_roi_head.py:31-33,243-244,288-289,437-438``) every extraction's
features go through it before the bbox or mask head: in training, serving
and OHEM's hard-mining pass.

A sampler that ``needs_hard_scores`` (OHEM) ranks the candidates by their
classification loss: every candidate of the batch is assigned and goes
through the bbox branch once more without gradient (one more RoIAlign
forward, no backward), and its loss against its label is its score.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...core.mask.mask_target import mask_target_from_crops
from ...registry import BBOX_ASSIGNERS, BBOX_SAMPLERS, HEADS, build_from_cfg
from ..builder import build_head, build_roi_extractor
from ..utils.additional import get_adaptive_scale_rois


def _rows(table, inds):
    """table (B, N, ...) at inds (B, S) -> (B, S, ...)."""
    return table[torch.arange(table.shape[0], device=table.device)[:, None],
                 inds]


def boxes_to_rois(boxes):
    """(B, S, 4) boxes -> (B * S, 5) RoIs, each with its image's index."""
    b, s = boxes.shape[:2]
    batch_inds = torch.arange(b, dtype=boxes.dtype,
                              device=boxes.device)[:, None, None]
    return torch.cat([batch_inds.expand(b, s, 1), boxes],
                     dim=-1).reshape(b * s, 5)


def assign_candidates(assigner, sampler, proposals, prop_valid, gt_bboxes,
                      gt_valid):
    """The candidates of each image, gts first when the sampler adds them
    (padded gts are invalid candidates), and their assignment: (boxes
    (B, N, 4), assigned_gt_inds (B, N), max_overlaps (B, N))."""
    if sampler.add_gt_as_proposals:
        boxes = torch.cat([gt_bboxes.float(), proposals[..., :4]], dim=1)
        box_valid = torch.cat([gt_valid, prop_valid], dim=1)
    else:
        boxes, box_valid = proposals[..., :4], prop_valid
    assign = assigner.assign(boxes, gt_bboxes, gt_valid, box_valid=box_valid)
    return boxes, assign['assigned_gt_inds'], assign['max_overlaps']


def sample_candidates(sampler, gen, boxes, assigned, max_overlaps, gt_bboxes,
                      gt_labels, hard_scores=None):
    """Each image's candidates sampled into the sampler's slots, positives
    first: the slots' candidate indices, boxes, matched gt indices, boxes
    and labels, and their is_pos / valid masks, all (B, S, ...).
    ``hard_scores`` (B, N) rank the candidates of an OHEM sampler."""
    sample = sampler.sample(gen, assigned, max_overlaps=max_overlaps,
                            num_gts=gt_bboxes.shape[1],
                            hard_scores=hard_scores)
    inds = sample['inds']
    safe_gt = torch.clamp(_rows(assigned, inds) - 1, 0,
                          gt_bboxes.shape[1] - 1)
    return dict(inds=inds, boxes=_rows(boxes, inds),
                gt_boxes=_rows(gt_bboxes.float(), safe_gt), gt_inds=safe_gt,
                labels=_rows(gt_labels.long(), safe_gt),
                is_pos=sample['is_pos'], valid=sample['valid'])


def mask_loss(mask_head, sampler, rois, sampled, gt_mask_crops, extract):
    """``mask_head``'s loss on the positive slots of (B * S, 5) ``rois``
    sampled by ``sampler``: it packs each image's positives into its
    leading slots, so only the first ``num * pos_fraction`` are extracted
    (``extract``: RoIs -> (R, oh, ow, C) features), against targets
    resampled from the batch's gt crops."""
    b, s = sampled['boxes'].shape[:2]
    cap = min(s, int(sampler.num * sampler.pos_fraction))
    mask_pred = mask_head(extract(rois.reshape(b, s, 5)[:, :cap]
                                  .reshape(b * cap, 5)))
    crops = _rows(gt_mask_crops, sampled['gt_inds'][:, :cap])
    targets = mask_target_from_crops(
        crops.reshape(b * cap, *crops.shape[2:]),
        sampled['gt_boxes'][:, :cap].reshape(-1, 4),
        sampled['boxes'][:, :cap].reshape(-1, 4),
        mask_size=mask_pred.shape[1])
    pos = sampled['is_pos'][:, :cap] & sampled['valid'][:, :cap]
    return mask_head.loss(mask_pred, targets,
                          sampled['labels'][:, :cap].reshape(-1),
                          pos.reshape(-1))


@HEADS.register_module()
class StandardRoIHead(nn.Module):
    def __init__(self, bbox_roi_extractor, bbox_head, mask_roi_extractor=None,
                 mask_head=None, shared_head=None, multi_rois=None,
                 adaptive_scale_fac=1.0, train_cfg=None, test_cfg=None):
        super().__init__()
        self.shared_head = None if shared_head is None \
            else build_head(shared_head)
        self.bbox_roi_extractor = build_roi_extractor(bbox_roi_extractor)
        self.bbox_head = build_head(bbox_head)
        self.with_mask = mask_head is not None
        if self.with_mask:
            self.mask_head = build_head(mask_head)
            # without its own extractor the mask branch shares the bbox one
            self.mask_roi_extractor = self.bbox_roi_extractor \
                if mask_roi_extractor is None \
                else build_roi_extractor(mask_roi_extractor)
        if multi_rois is None:
            multi_rois = getattr(self.bbox_head, 'num_roi_groups', 1) == 3
        self.multi_rois = multi_rois
        self.adaptive_scale_fac = adaptive_scale_fac
        self.with_multi_cls = getattr(self.bbox_head, 'with_multi_cls', False)
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        if train_cfg is not None:
            self.assigner = build_from_cfg(train_cfg['assigner'],
                                           BBOX_ASSIGNERS)
            # a config without a sampler takes the assignment as it is
            self.sampler = build_from_cfg(
                train_cfg.get('sampler', dict(type='PseudoSampler')),
                BBOX_SAMPLERS)

    @property
    def num_classes(self):
        return self.bbox_head.num_classes

    @property
    def num_extractions(self):
        """RoIAlign calls in one request: the boxes', and the mask
        branch's."""
        return 1 + self.with_mask

    @property
    def num_step_extractions(self):
        """RoIAlign calls in one step that take a gradient: as many."""
        return self.num_extractions

    @property
    def serves_masks(self):
        """Whether a request gives mask logits."""
        return self.with_mask

    @property
    def stage_samplers(self):
        return [self.sampler]

    def classifiers(self):
        """The layers that give the class logits."""
        return [self.bbox_head.fc_cls]

    def _through_shared_head(self, roi_feats):
        """RoI features (R, oh, ow, C) through the shared head where there
        is one."""
        return roi_feats if self.shared_head is None \
            else self.shared_head(roi_feats)

    def _extract(self, extractor, feats, rois):
        """RoI features (R, oh, ow, C) of ``extractor``, through the shared
        head where there is one."""
        return self._through_shared_head(
            extractor(feats[:extractor.num_inputs], rois))

    def _bbox_forward(self, feats, rois, num_imgs=1):
        """The head's outputs for (R, 5) RoIs of ``num_imgs`` images:
        (cls_score, bbox_pred), and multi_cls for a "+fac" head."""
        extractor = self.bbox_roi_extractor
        lvl_feats = feats[:extractor.num_inputs]
        if self.multi_rois:
            lh_rois, lw_rois = get_adaptive_scale_rois(
                rois, self.adaptive_scale_fac)
            all_feats = extractor(lvl_feats,
                                  torch.cat([rois, lw_rois, lh_rois]))
            bbox_feats = torch.cat(all_feats.chunk(3), dim=-1)
        else:
            bbox_feats = extractor(lvl_feats, rois)
        bbox_feats = self._through_shared_head(bbox_feats)
        if self.with_multi_cls:
            return self.bbox_head(bbox_feats, num_imgs=num_imgs)
        return self.bbox_head(bbox_feats)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def _assign(self, proposals, prop_valid, gt_bboxes, gt_valid):
        """``assign_candidates`` with this head's assigner and sampler."""
        return assign_candidates(self.assigner, self.sampler, proposals,
                                 prop_valid, gt_bboxes, gt_valid)

    def forward_train(self, feats, proposals, prop_valid, gt_bboxes,
                      gt_valid, gt_labels, gen, gt_mask_crops=None,
                      img_shapes=None):
        """Bbox (and mask) losses of a batch.

        Args:
            feats: per-level (B, C, H, W) features.
            proposals: (B, P, 5); prop_valid (B, P).
            gt_bboxes: (B, G, 4) padded; gt_valid (B, G); gt_labels (B, G).
            gen: the ``torch.Generator`` of the sampler's priorities.
            gt_mask_crops: (B, G, cs, cs) each gt's mask cut to its box
                (``BitmapMasks.to_fixed_crops``); required with a mask head.
            img_shapes: (B, 2), unused here (the cascade head clamps its
                refined boxes to them).
        Returns:
            dict of ``loss_cls``, ``acc`` and ``loss_bbox``, and
            ``loss_multi_cls`` for a "+fac" head, ``loss_mask`` with a mask
            head.
        """
        boxes, assigned, max_overlaps = self._assign(proposals, prop_valid,
                                                     gt_bboxes, gt_valid)
        hard_scores = self._candidate_hard_scores(
            feats, boxes, assigned, gt_labels) \
            if self.sampler.needs_hard_scores else None
        sampled = sample_candidates(self.sampler, gen, boxes, assigned,
                                    max_overlaps, gt_bboxes, gt_labels,
                                    hard_scores)
        boxes = sampled['boxes']
        b = boxes.shape[0]
        # every slot is extracted, invalid ones too: their loss weight is 0
        rois = boxes_to_rois(boxes)
        out = self._bbox_forward(feats, rois, num_imgs=b)
        labels, label_weights, bbox_targets, bbox_weights = \
            self.bbox_head.get_targets(
                boxes, sampled['gt_boxes'], sampled['labels'],
                sampled['is_pos'], sampled['valid'],
                self.train_cfg.get('pos_weight', -1))
        loss_kw = {}
        if self.with_multi_cls:
            # each image's classes among its weighted slots, background too
            onehot = F.one_hot(labels, self.bbox_head.num_classes + 1)
            presence = (onehot * label_weights[..., None]).sum(dim=1) > 0
            loss_kw = dict(multi_cls=out[2], presence=presence.int())
        losses = self.bbox_head.loss(
            out[0], out[1], labels.reshape(-1),
            label_weights.reshape(-1), bbox_targets.reshape(-1, 4),
            bbox_weights.reshape(-1, 4), **loss_kw)
        if self.with_mask:
            losses.update(self._mask_forward_train(feats, rois, sampled,
                                                   gt_mask_crops))
        return losses

    @torch.no_grad()
    def _candidate_hard_scores(self, feats, boxes, assigned, gt_labels):
        """OHEM's scores (B, N): each candidate's classification loss
        against its label (the background where it is not a positive), from
        one forward of the bbox branch over all B x N candidates without
        gradient."""
        b, n = boxes.shape[:2]
        cls_score = self._bbox_forward(feats, boxes_to_rois(boxes),
                                       num_imgs=b)[0]
        safe = torch.clamp(assigned - 1, 0, gt_labels.shape[1] - 1)
        labels = torch.where(assigned > 0, _rows(gt_labels.long(), safe),
                             self.bbox_head.num_classes)
        loss = self.bbox_head.loss_cls(cls_score.float(), labels.reshape(-1),
                                       reduction_override='none')
        return loss.reshape(b, n)

    def _mask_forward_train(self, feats, rois, sampled, gt_mask_crops):
        """The mask loss of the positive slots (ref:
        standard_roi_head.py:189-223, :func:`mask_loss`)."""
        if gt_mask_crops is None:
            raise ValueError('mask training needs gt_mask_crops in the '
                             'batch')
        return mask_loss(
            self.mask_head, self.sampler, rois, sampled, gt_mask_crops,
            lambda r: self._extract(self.mask_roi_extractor, feats, r))

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------

    def simple_test_bboxes(self, feats, proposals, proposal_valid,
                           img_shapes, scale_factors, rescale=False,
                           cfg=None):
        """dets (B, max_per_img, 5), labels, valid from (B, P, 5) proposals
        and their (B, P) validity."""
        cfg = self.test_cfg if cfg is None else cfg
        b, p, _ = proposals.shape
        cls_score, bbox_pred = self._bbox_forward(
            feats, boxes_to_rois(proposals[..., :4]), num_imgs=b)[:2]
        cls_score = cls_score.reshape(b, p, -1)
        if bbox_pred is not None:
            bbox_pred = bbox_pred.reshape(b, p, -1)
        return self.bbox_head.get_bboxes(
            proposals[..., :4], cls_score, bbox_pred, img_shapes,
            scale_factors, rescale=rescale, cfg=cfg,
            valid_mask=proposal_valid)

    def simple_test(self, feats, proposals, proposal_valid, img_shapes,
                    scale_factors, rescale=False):
        """(dets, labels, valid), and with a mask head their mask logits
        (B, max_per_img, mh, mw)."""
        dets, labels, valid = self.simple_test_bboxes(
            feats, proposals, proposal_valid, img_shapes, scale_factors,
            rescale=rescale)
        if not self.with_mask:
            return dets, labels, valid
        return dets, labels, valid, self.simple_test_mask(
            feats, dets, labels, scale_factors, rescale=rescale)

    def simple_test_mask(self, feats, dets, labels, scale_factors,
                         rescale=False):
        """The mask logits of every detection slot on its label's channel
        (ref: test_mixins.py:110-146): (B, n, mh, mw). Detections in the
        original image's scale (``rescale``) are mapped back to the input's;
        the paste into the image happens on the host
        (``core.mask.paste_masks_np``)."""
        b, n, _ = dets.shape
        boxes = dets[..., :4]
        if rescale:
            boxes = boxes * scale_factors[:, None, :4]
        mask_pred = self.mask_head(self._extract(self.mask_roi_extractor,
                                                 feats, boxes_to_rois(boxes)))
        mh, mw = mask_pred.shape[1:3]
        mask_pred = mask_pred.reshape(b, n, mh, mw, -1)
        index = labels.long()[:, :, None, None, None].expand(b, n, mh, mw, 1)
        return torch.gather(mask_pred, -1, index)[..., 0]
