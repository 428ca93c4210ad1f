"""Random sampling into fixed slots (counterpart of
``arfe_tpu/core/bbox/samplers.py:17-110``), and the pseudo sampler that
takes every candidate.

Sampling without replacement ranks uniform random priorities: the k
smallest finite priorities win, ties to the lower index (a stable sort, as
``jax.lax.top_k`` breaks ties). Batched over images: ``assigned_gt_inds``
is (B, N) and every output (B, num). Priorities come from a
``torch.Generator`` on the device of the assignment.
"""
from __future__ import annotations

import torch

from ...registry import BBOX_SAMPLERS


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

    def __init__(self, num, pos_fraction, neg_pos_ub=-1,
                 add_gt_as_proposals=True, **kwargs):
        self.num = num
        self.pos_fraction = pos_fraction
        self.neg_pos_ub = neg_pos_ub
        self.add_gt_as_proposals = add_gt_as_proposals

    @staticmethod
    def _uniform(gen, cand):
        draw = torch.rand(cand.shape, generator=gen, device=cand.device)
        return torch.where(cand, draw, float('inf'))

    def _pos_priority(self, gen, cand, ctx):
        return self._uniform(gen, cand)

    def _neg_priority(self, gen, cand, ctx):
        return self._uniform(gen, cand)

    def sample(self, gen, assigned_gt_inds, **ctx):
        """Up to ``num * pos_fraction`` positives, then negatives.

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


@BBOX_SAMPLERS.register_module()
class PseudoSampler:
    """Every candidate in its own slot, no subsampling (counterpart of
    ``arfe_tpu/core/bbox/samplers.py:244-258``): positives are assigned > 0,
    the valid slots assigned >= 0 (the ignored ones are not)."""

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
