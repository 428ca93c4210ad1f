"""COCO-style detection evaluation (numpy).

The port's own copy of ``arfe_tpu/core/evaluation/coco_eval.py`` (the port
imports nothing of the JAX package), without the ``segm`` IoU, which comes
with Mask R-CNN (ROADMAP §1). It re-implements COCOeval's
bbox/proposal protocol — the metric definition the
reference relies on (ref: mmdet/datasets/coco.py:320-430 -> pycocotools
COCOeval): greedy per-image per-category matching at 10 IoU thresholds,
crowd/ignore handling, 101-point interpolated precision over
{all, small, medium, large} x maxDets, and the standard 12-number summary.
"""
from __future__ import annotations

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    'all': (0.0, 1e10),
    'small': (0.0, 32.0 ** 2),
    'medium': (32.0 ** 2, 96.0 ** 2),
    'large': (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_xywh(dets, gts, iscrowd):
    """pycocotools-style IoU: boxes [x, y, w, h]; for crowd gt the
    denominator is the det area only."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    ix1 = np.maximum(dx1[:, None], gx1[None, :])
    iy1 = np.maximum(dy1[:, None], gy1[None, :])
    ix2 = np.minimum(dx2[:, None], gx2[None, :])
    iy2 = np.minimum(dy2[:, None], gy2[None, :])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    d_area = (dets[:, 2] * dets[:, 3])[:, None]
    g_area = (gts[:, 2] * gts[:, 3])[None, :]
    union = np.where(iscrowd[None, :], d_area, d_area + g_area - inter)
    return inter / np.maximum(union, 1e-10)


class COCOEvaluator:
    """Evaluate detections against a ground-truth ``data.coco_api.COCO``.

    Args:
        coco_gt: ground-truth COCO object.
        iou_type: 'bbox' (or 'proposal' via use_cats=False).
    """

    def __init__(self, coco_gt, iou_type='bbox', use_cats=True,
                 max_dets=MAX_DETS, area_rngs=None, iou_thrs=None):
        if iou_type == 'segm':
            raise NotImplementedError('COCOEvaluator: the segm IoU comes '
                                      'with Mask R-CNN')
        if iou_type not in ('bbox', 'proposal'):
            raise ValueError(f'COCOEvaluator: iou_type {iou_type!r}')
        self.iou_type = iou_type
        self.iou_thrs = np.asarray(iou_thrs) if iou_thrs is not None \
            else IOU_THRS
        self.coco_gt = coco_gt
        self.use_cats = use_cats and iou_type != 'proposal'
        self.max_dets = tuple(max_dets)
        self.area_rngs = area_rngs or AREA_RNGS
        self.img_ids = coco_gt.getImgIds()
        self.cat_ids = coco_gt.getCatIds() if self.use_cats else [-1]

    # ------------------------------------------------------------------
    def _gather(self, coco_dt):
        """Index gt/dt per (img, cat)."""
        gts = {}
        dts = {}
        for iid in self.img_ids:
            for ann in self.coco_gt.img_ann_map[iid]:
                key = (iid, ann['category_id'] if self.use_cats else -1)
                gts.setdefault(key, []).append(ann)
            for ann in coco_dt.img_ann_map[iid]:
                key = (iid, ann['category_id'] if self.use_cats else -1)
                dts.setdefault(key, []).append(ann)
        return gts, dts

    @staticmethod
    def _ann_ious(dt_anns, gt_anns, iscrowd):
        d_boxes = np.array([d['bbox'] for d in dt_anns]).reshape(-1, 4)
        g_boxes = np.array([g['bbox'] for g in gt_anns]).reshape(-1, 4)
        return _iou_xywh(d_boxes, g_boxes, iscrowd)

    def _evaluate_img(self, gt_anns, dt_anns, area_rng, max_det):
        """Greedy matching for one (img, cat) — pycocotools evaluateImg."""
        gt_ignore = np.array([
            bool(g.get('ignore', 0)) or bool(g.get('iscrowd', 0))
            or g['area'] < area_rng[0] or g['area'] > area_rng[1]
            for g in gt_anns], dtype=bool)
        # sort gts: non-ignored first (pycocotools order)
        g_order = np.argsort(gt_ignore, kind='stable')
        gt_anns = [gt_anns[i] for i in g_order]
        gt_ignore = gt_ignore[g_order]
        iscrowd = np.array([bool(g.get('iscrowd', 0)) for g in gt_anns])

        scores = np.array([d['score'] for d in dt_anns])
        d_order = np.argsort(-scores, kind='mergesort')[:max_det]
        dt_anns = [dt_anns[i] for i in d_order]

        ious = self._ann_ious(dt_anns, gt_anns, iscrowd)

        nd, ng = len(dt_anns), len(gt_anns)
        t = len(self.iou_thrs)
        dt_matched = np.zeros((t, nd), dtype=np.int64)   # matched gt idx + 1
        gt_matched = np.zeros((t, ng), dtype=np.int64)
        dt_ignore = np.zeros((t, nd), dtype=bool)
        for ti, thr in enumerate(self.iou_thrs):
            for di in range(nd):
                best_iou = min(thr, 1 - 1e-10)
                best_g = -1
                for gi in range(ng):
                    if gt_matched[ti, gi] and not iscrowd[gi]:
                        continue
                    # stop at ignored gts once a non-ignored match exists
                    if best_g > -1 and not gt_ignore[best_g] \
                            and gt_ignore[gi]:
                        break
                    if ious[di, gi] < best_iou:
                        continue
                    best_iou = ious[di, gi]
                    best_g = gi
                if best_g == -1:
                    continue
                dt_ignore[ti, di] = gt_ignore[best_g]
                dt_matched[ti, di] = best_g + 1
                gt_matched[ti, best_g] = di + 1
        # unmatched dets outside area range are ignored
        d_areas = np.array([d.get('area', d['bbox'][2] * d['bbox'][3])
                            for d in dt_anns])
        out_of_rng = (d_areas < area_rng[0]) | (d_areas > area_rng[1])
        dt_ignore = dt_ignore | (out_of_rng[None, :] & (dt_matched == 0))
        return dict(
            dt_scores=np.array([d['score'] for d in dt_anns]),
            dt_matched=dt_matched,
            dt_ignore=dt_ignore,
            num_gt=int((~gt_ignore).sum()),
        )

    # ------------------------------------------------------------------
    def evaluate(self, coco_dt):
        """Returns dict with 'precision' (T, R, K, A, M), 'recall'
        (T, K, A, M) and the 12 standard stats."""
        gts, dts = self._gather(coco_dt)
        t = len(self.iou_thrs)
        r = len(RECALL_THRS)
        k_num = len(self.cat_ids)
        a_num = len(self.area_rngs)
        m_num = len(self.max_dets)
        precision = -np.ones((t, r, k_num, a_num, m_num))
        recall = -np.ones((t, k_num, a_num, m_num))

        area_items = list(self.area_rngs.items())
        max_det_top = max(self.max_dets)
        for ki, cid in enumerate(self.cat_ids):
            for ai, (_, arng) in enumerate(area_items):
                evals = []
                for iid in self.img_ids:
                    g = gts.get((iid, cid), [])
                    d = dts.get((iid, cid), [])
                    if not g and not d:
                        continue
                    evals.append(
                        self._evaluate_img(g, d, arng, max_det_top))
                if not evals:
                    continue
                for mi, max_det in enumerate(self.max_dets):
                    scores = np.concatenate(
                        [e['dt_scores'][:max_det] for e in evals])
                    order = np.argsort(-scores, kind='mergesort')
                    matched = np.concatenate(
                        [e['dt_matched'][:, :max_det] for e in evals],
                        axis=1)[:, order]
                    ignored = np.concatenate(
                        [e['dt_ignore'][:, :max_det] for e in evals],
                        axis=1)[:, order]
                    npig = sum(e['num_gt'] for e in evals)
                    if npig == 0:
                        continue
                    tps = (matched > 0) & ~ignored
                    fps = (matched == 0) & ~ignored
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for ti in range(t):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0
                        # monotone precision envelope
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, RECALL_THRS, side='left')
                        q = np.zeros(r)
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precision[ti, :, ki, ai, mi] = q

        stats = self._summarize(precision, recall)
        return dict(precision=precision, recall=recall, stats=stats)

    def _summarize(self, precision, recall):
        def _ap(iou_thr=None, area='all', max_det=100):
            ai = list(self.area_rngs).index(area)
            mi = self.max_dets.index(max_det)
            p = precision[:, :, :, ai, mi]
            if iou_thr is not None:
                hits = np.where(np.isclose(self.iou_thrs, iou_thr))[0]
                if not len(hits):   # custom iou_thrs without this point
                    return -1.0
                ti = int(hits[0])
                p = p[ti:ti + 1]
            p = p[p > -1]
            return float(p.mean()) if p.size else -1.0

        def _ar(area='all', max_det=100):
            ai = list(self.area_rngs).index(area)
            mi = self.max_dets.index(max_det)
            rr = recall[:, :, ai, mi]
            rr = rr[rr > -1]
            return float(rr.mean()) if rr.size else -1.0

        md = self.max_dets
        return {
            'AP': _ap(), 'AP50': _ap(0.5), 'AP75': _ap(0.75),
            'APs': _ap(area='small'), 'APm': _ap(area='medium'),
            'APl': _ap(area='large'),
            f'AR@{md[0]}': _ar(max_det=md[0]),
            f'AR@{md[1]}': _ar(max_det=md[1]),
            f'AR@{md[2]}': _ar(max_det=md[2]),
            'ARs': _ar(area='small'), 'ARm': _ar(area='medium'),
            'ARl': _ar(area='large'),
        }
