"""Sampling into fixed slots (counterpart of
``arfe_tpu/core/bbox/samplers.py``): random, instance-balanced positives,
IoU-balanced negatives, a combination of two, OHEM's hard examples, and
the pseudo sampler that takes every candidate.

Sampling without replacement ranks priorities: the k smallest finite ones
win, ties to the lower index (a stable sort, as ``jax.lax.top_k`` breaks
ties). Batched over images: ``assigned_gt_inds`` is (B, N) and every output
(B, num). Every random priority is built from the uniform draws of
:meth:`BaseStaticSampler._uniform`, the one place that draws, from a
``torch.Generator`` on the device of the assignment; the balanced samplers
rank within groups of those draws, so a check that fixes the draws keeps
their ranking live. The balanced samplers keep the JAX package's static
round-robin forms of the reference's per-group quotas.
"""
from __future__ import annotations

import torch

from ...registry import BBOX_SAMPLERS, build_from_cfg


def _pick_k_smallest(priority, k_static, limit):
    """Indices of the ``limit`` (B,) (at most ``k_static``) smallest finite
    priorities of each row of (B, N): (idx (B, k), ok (B, k) bool), in
    rising priority."""
    k = min(k_static, priority.shape[-1])
    vals, idx = torch.sort(priority, dim=-1, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    rank = torch.arange(k, device=priority.device)
    return idx, (rank < limit[..., None]) & torch.isfinite(vals)


class BaseStaticSampler:
    """Quota logic and the compression into ``num`` slots. Subclasses
    override ``_pos_priority`` / ``_neg_priority``: a lower priority is
    preferred, ``inf`` means not a candidate."""

    needs_hard_scores = False

    def __init__(self, num, pos_fraction, neg_pos_ub=-1,
                 add_gt_as_proposals=True, **kwargs):
        self.num = num
        self.pos_fraction = pos_fraction
        self.neg_pos_ub = neg_pos_ub
        self.add_gt_as_proposals = add_gt_as_proposals

    def _uniform(self, gen, cand, side):
        """Uniform draws in [0, 1) for the (B, N) candidates of ``side``
        (``'pos'`` or ``'neg'``), ``inf`` where a box is not one."""
        draw = torch.rand(cand.shape, generator=gen, device=cand.device)
        return torch.where(cand, draw, float('inf'))

    def _pos_priority(self, gen, cand, ctx):
        return self._uniform(gen, cand, 'pos')

    def _neg_priority(self, gen, cand, ctx):
        return self._uniform(gen, cand, 'neg')

    def sample(self, gen, assigned_gt_inds, **ctx):
        """Up to ``num * pos_fraction`` positives, then negatives.

        ``ctx`` may hold ``max_overlaps`` (B, N) for IoU-balanced
        negatives, ``num_gts`` (the padded gt count) for instance-balanced
        positives and ``hard_scores`` (B, N) for OHEM.

        Returns dict(inds (B, num) int64 candidate indices, is_pos (B, num),
        valid (B, num)): the selected positives take the leading slots, the
        negatives the next ones, and invalid slots come last.
        """
        pos_cand = assigned_gt_inds > 0
        neg_cand = assigned_gt_inds == 0
        ctx = dict(ctx, assigned_gt_inds=assigned_gt_inds)

        num_expected_pos = int(self.num * self.pos_fraction)
        num_pos = torch.clamp(pos_cand.sum(-1), max=num_expected_pos)
        pos_idx, pos_ok = _pick_k_smallest(
            self._pos_priority(gen, pos_cand, ctx), num_expected_pos, num_pos)

        num_neg_expected = self.num - num_pos
        if self.neg_pos_ub >= 0:
            num_neg_expected = torch.minimum(
                num_neg_expected,
                torch.clamp(num_pos * self.neg_pos_ub, min=1))
        num_neg = torch.minimum(num_neg_expected, neg_cand.sum(-1))
        neg_idx, neg_ok = _pick_k_smallest(
            self._neg_priority(gen, neg_cand, ctx), self.num, num_neg)

        cand_idx = torch.cat([pos_idx, neg_idx], dim=-1)
        cand_score = torch.cat([2.0 * pos_ok.float(), neg_ok.float()], dim=-1)
        k = min(self.num, cand_idx.shape[-1])
        slot = torch.sort(-cand_score, dim=-1, stable=True)[1][..., :k]
        picked = torch.gather(cand_score, -1, slot)
        inds = torch.gather(cand_idx, -1, slot)
        is_pos, valid = picked >= 2.0, picked >= 1.0
        if k < self.num:
            pad = (0, self.num - k)
            inds = torch.nn.functional.pad(inds, pad)
            is_pos = torch.nn.functional.pad(is_pos, pad)
            valid = torch.nn.functional.pad(valid, pad)
        return dict(inds=inds, is_pos=is_pos, valid=valid)


@BBOX_SAMPLERS.register_module()
class RandomSampler(BaseStaticSampler):
    """Uniformly random positives and negatives."""


def _group_balanced_priority(draw, cand, group_ids):
    """Rank within group plus the draw (``arfe_tpu/core/bbox/samplers.py:
    111-126``): taking the k smallest round-robins across groups, the
    static form of per-group quotas with a random fill. ``draw`` is (B, N)
    with ``inf`` off the candidates; the rank of a candidate counts the
    candidates of its group with a smaller draw."""
    smaller = (draw[..., :, None] > draw[..., None, :]) & cand[..., None, :]
    same_group = group_ids[..., :, None] == group_ids[..., None, :]
    rank = (smaller & same_group).sum(-1)
    return torch.where(cand, rank.float() + draw, float('inf'))


@BBOX_SAMPLERS.register_module()
class InstanceBalancedPosSampler(BaseStaticSampler):
    """Positives balanced across the gt instances they match, over the
    padded gt count ``num_gts`` groups."""

    def _pos_priority(self, gen, cand, ctx):
        g = int(ctx.get('num_gts', 128))
        groups = torch.clamp(ctx['assigned_gt_inds'] - 1, 0, g - 1)
        return _group_balanced_priority(self._uniform(gen, cand, 'pos'), cand,
                                        groups)


@BBOX_SAMPLERS.register_module()
class IoUBalancedNegSampler(BaseStaticSampler):
    """Negatives balanced across ``num_bins`` bins of their IoU over
    ``[max(floor_thr, 0), 0.5)``; with ``floor_thr >= 0`` those under it
    form one more group, whose ranks are stretched to give it about
    ``floor_fraction`` of every selection prefix."""

    def __init__(self, num, pos_fraction, floor_thr=-1, floor_fraction=0,
                 num_bins=3, **kwargs):
        super().__init__(num, pos_fraction, **kwargs)
        self.floor_thr = floor_thr
        self.floor_fraction = floor_fraction
        self.num_bins = num_bins

    def _neg_priority(self, gen, cand, ctx):
        draw = self._uniform(gen, cand, 'neg')
        overlaps = ctx.get('max_overlaps')
        if overlaps is None:
            return draw
        floor = max(self.floor_thr, 0.0)
        binned = torch.clamp(((overlaps - floor) / max(0.5 - floor, 1e-6)
                              * self.num_bins).int(), 0, self.num_bins - 1)
        in_floor = overlaps < self.floor_thr if self.floor_thr >= 0 \
            else torch.zeros_like(cand)
        group = torch.where(in_floor, self.num_bins, binned)
        prio = _group_balanced_priority(draw, cand, group)
        if self.floor_fraction > 0:
            scale = (1 - self.floor_fraction) / max(self.floor_fraction,
                                                    1e-6) / self.num_bins
            prio = torch.where(in_floor & cand, prio * scale, prio)
        return prio


@BBOX_SAMPLERS.register_module()
class OHEMSampler(BaseStaticSampler):
    """Online hard example mining: positives and negatives of the highest
    classification loss, ``hard_scores`` (B, N), which the RoI head
    computes over every candidate without gradient; uniform draws without
    them."""

    needs_hard_scores = True

    def __init__(self, num, pos_fraction, context=None, **kwargs):
        super().__init__(num, pos_fraction, **kwargs)

    def _hard_priority(self, gen, cand, ctx, side):
        hard = ctx.get('hard_scores')
        if hard is None:
            return self._uniform(gen, cand, side)
        return torch.where(cand, -hard, float('inf'))

    def _pos_priority(self, gen, cand, ctx):
        return self._hard_priority(gen, cand, ctx, 'pos')

    def _neg_priority(self, gen, cand, ctx):
        return self._hard_priority(gen, cand, ctx, 'neg')


@BBOX_SAMPLERS.register_module()
class ScoreHLRSampler(OHEMSampler):
    """The JAX package's form of score-based hard-loss ranking: OHEM's
    ranking, without the reference's score-guided reweighting."""


@BBOX_SAMPLERS.register_module()
class CombinedSampler(BaseStaticSampler):
    """Positives by one sampler, negatives by another, both built with the
    outer ``num`` and ``pos_fraction``."""

    def __init__(self, num, pos_fraction, pos_sampler=None, neg_sampler=None,
                 **kwargs):
        super().__init__(num, pos_fraction, **kwargs)
        common = dict(num=num, pos_fraction=pos_fraction)
        self.pos_sampler = build_from_cfg(
            dict(common, **(pos_sampler or dict(type='RandomSampler'))),
            BBOX_SAMPLERS)
        self.neg_sampler = build_from_cfg(
            dict(common, **(neg_sampler or dict(type='RandomSampler'))),
            BBOX_SAMPLERS)
        self.needs_hard_scores = (self.pos_sampler.needs_hard_scores
                                  or self.neg_sampler.needs_hard_scores)

    def _pos_priority(self, gen, cand, ctx):
        return self.pos_sampler._pos_priority(gen, cand, ctx)

    def _neg_priority(self, gen, cand, ctx):
        return self.neg_sampler._neg_priority(gen, cand, ctx)


@BBOX_SAMPLERS.register_module()
class RandomSamplerPrior(RandomSampler):
    """The ARFE name of the random sampler, kept for its configs."""


@BBOX_SAMPLERS.register_module()
class PseudoSampler:
    """Every candidate in its own slot, no subsampling (counterpart of
    ``arfe_tpu/core/bbox/samplers.py:244-258``): positives are assigned > 0,
    the valid slots assigned >= 0 (the ignored ones are not)."""

    needs_hard_scores = False
    add_gt_as_proposals = False

    def __init__(self, **kwargs):
        pass

    def sample(self, gen, assigned_gt_inds, **ctx):
        """dict(inds (B, N), is_pos (B, N), valid (B, N)) of the (B, N)
        assignment; ``gen`` is not drawn from."""
        b, n = assigned_gt_inds.shape
        inds = torch.arange(n, device=assigned_gt_inds.device).expand(b, n)
        return dict(inds=inds, is_pos=assigned_gt_inds > 0,
                    valid=assigned_gt_inds >= 0)
