"""Auxiliary RoIs of AR-RFF (counterpart of
``arfe_tpu/models/utils/additional.py``).

Every function takes (R, 5) RoIs [batch, x1, y1, x2, y2] and returns scaled
variants with the reference's arithmetic: widths and heights count one pixel
more (``x2 - x1 + 1``), and only x1 and y1 are floored, at 0.1; x2 and y2 may
reach past the image.
"""
from __future__ import annotations

import torch


def _parts(rois):
    ctr_x = (rois[:, 1] + rois[:, 3]) * 0.5
    ctr_y = (rois[:, 2] + rois[:, 4]) * 0.5
    rw = rois[:, 3] - rois[:, 1] + 1.0
    rh = rois[:, 4] - rois[:, 2] + 1.0
    return ctr_x, ctr_y, rw, rh


def _make(rois, x1, y1, x2, y2):
    return torch.stack([rois[:, 0], torch.clamp(x1, min=0.1),
                        torch.clamp(y1, min=0.1), x2, y2], dim=-1)


def get_large_small_rois(rois, large_rate=2.0, small_rate=0.5):
    """RoIs enlarged by ``large_rate`` and shrunk by ``small_rate`` about
    their centres."""
    cx, cy, rw, rh = _parts(rois)
    lw, lh = rw * large_rate, rh * large_rate
    sw, sh = rw * small_rate, rh * small_rate
    large = _make(rois, cx - lw * .5, cy - lh * .5, cx + lw * .5,
                  cy + lh * .5)
    small = _make(rois, cx - sw * .5, cy - sh * .5, cx + sw * .5,
                  cy + sh * .5)
    return large, small


def get_adaptive_scale_rois(rois, facs):
    """Stretched by the aspect ratio: ``h_rate = (w / h) * facs + 1`` and
    ``w_rate = (h / w) * facs + 1``. Returns ``(adaptive_h, adaptive_w)``:
    the first stretches the height only, the second stretches both axes."""
    cx, cy, rw, rh = _parts(rois)
    h_rate = (rw / rh) * facs + 1.0
    w_rate = (rh / rw) * facs + 1.0
    lh = rh * h_rate
    lw = rw * w_rate
    adaptive_h = _make(rois, cx - rw * .5, cy - lh * .5, cx + rw * .5,
                       cy + lh * .5)
    adaptive_w = _make(rois, cx - lw * .5, cy - lh * .5, cx + lw * .5,
                       cy + lh * .5)
    return adaptive_h, adaptive_w


def get_large_wh_rois(rois, large_rate=3.0):
    """RoIs elongated by ``large_rate`` along x, and along y."""
    cx, cy, rw, rh = _parts(rois)
    lw, lh = rw * large_rate, rh * large_rate
    large_w = _make(rois, cx - lw * .5, cy - rh * .5, cx + lw * .5,
                    cy + rh * .5)
    large_h = _make(rois, cx - rw * .5, cy - lh * .5, cx + rw * .5,
                    cy + lh * .5)
    return large_w, large_h


def get_small_wh_rois(rois, small_rate=0.33):
    """RoIs shrunk along y, and along x; the second takes its y1 from the
    first's shrunk height, as the reference does."""
    cx, cy, rw, rh = _parts(rois)
    lw_w, lw_h = rw, rh * small_rate
    lh_w, lh_h = rw * small_rate, rh
    small_w = _make(rois, cx - lw_w * .5, cy - lw_h * .5, cx + lw_w * .5,
                    cy + lw_h * .5)
    small_h = _make(rois, cx - lh_w * .5, cy - lw_h * .5, cx + lh_w * .5,
                    cy + lh_h * .5)
    return small_w, small_h


def get_boundary_rois(rois, small_rate=0.5):
    """Four strips centred on the edges: (top, right, bottom, left)."""
    cx, cy, rw, rh = _parts(rois)
    sw, sh = rw * small_rate, rh * small_rate
    x1, y1, x2, y2 = rois[:, 1], rois[:, 2], rois[:, 3], rois[:, 4]
    top = _make(rois, cx - sw, y1 - sh * .5, cx + sw, y1 + sh * .5)
    bottom = _make(rois, cx - sw, y2 - sh * .5, cx + sw, y2 + sh * .5)
    left = _make(rois, x1 - sw * .5, cy - sh, x1 + sw * .5, cy + sh)
    right = _make(rois, x2 - sw * .5, cy - sh, x2 + sw * .5, cy + sh)
    return top, right, bottom, left


def get_context_rois(rois):
    """Context RoIs with the aspect ratio capped at 2: ``(ctx_h, ctx_w)``."""
    cx, cy, rw, rh = _parts(rois)
    wdh = torch.clamp(rw / rh, max=2.0)
    hdw = torch.clamp(rh / rw, max=2.0)
    wide = rh < rw
    h1_rate = torch.where(wide, wdh, 0.0) + 1.0
    w1_rate = torch.where(wide, 0.0, hdw) + 1.0
    h2_rate = wdh + 1.0
    w2_rate = hdw + 1.0
    ctx_h = _make(rois, cx - rw * w1_rate * .5, cy - rh * h1_rate * .5,
                  cx + rw * w1_rate * .5, cy + rh * h1_rate * .5)
    ctx_w = _make(rois, cx - rw * w2_rate * .5, cy - rh * h2_rate * .5,
                  cx + rw * w2_rate * .5, cy + rh * h2_rate * .5)
    return ctx_h, ctx_w
