"""Top-k accuracy (counterpart of ``arfe_tpu/models/losses/accuracy.py``)."""
from __future__ import annotations

import torch


def accuracy(pred, target, topk=1, valid_mask=None):
    """Percentage of rows of ``pred`` (N, C) whose top-k classes, ties in
    class order, hold ``target`` (N,); over the ``valid_mask`` rows if
    given. Returns a scalar tensor, or a list for a tuple ``topk``."""
    single = isinstance(topk, int)
    topks = (topk,) if single else tuple(topk)
    order = torch.sort(-pred, dim=-1, stable=True)[1][:, :max(topks)]
    correct = order == target[:, None]
    if valid_mask is None:
        res = [correct[:, :k].any(dim=1).sum() * 100.0 / pred.shape[0]
               for k in topks]
    else:
        denom = torch.clamp(valid_mask.sum(), min=1)
        res = [(correct[:, :k].any(dim=1) & valid_mask).sum() * 100.0
               / denom for k in topks]
    return res[0] if single else res
