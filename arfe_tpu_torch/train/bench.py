"""The bench's training set-up, and one training step on the card against
the CPU.

``chip_smoke.py``, ``tools/profile_train.py`` and the ``gpu``-marked tests
take their batch, their trainer and their card-against-CPU comparison from
here:

- :func:`synthetic_batch`: the bench's batch (``bench.py:170-188``), with
  its random 28 x 28 gt mask crops for Mask R-CNN;
- :func:`build_trainer`: the flagship with its ``train_cfg`` and the bench's
  SGD schedule (``bench.py:163-168``);
- :func:`compare_with_cpu`: the losses and gradients of one f32 step of a
  model on the card against the same weights on the CPU (plain path), with
  the same sampling draws (:func:`fix_priorities`), the CPU's choice of
  proposals, and for OHEM the CPU's hard scores; and the card's own choice
  of proposals against the plain path's on the card's candidates
  (:func:`selection_faults`).
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from .optimizer import (build_lr_schedule, build_optimizer,
                        frozen_prefixes_from_cfg)
from .train_step import parse_losses

_CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..',
                        '..', 'configs')
FLAGSHIP_CFG = os.path.join(_CONFIGS, '_base_', 'models',
                            'faster_rcnn_r50_arfpn.py')
#: the AR-RFF flagship (config #4) and the "+fac" detector
ARFE_CFGS = {name: os.path.join(_CONFIGS, 'arfe',
                                f'faster_rcnn_r50_arfpn_{name}_1x_coco.py')
             for name in ('arrff', 'fac')}
#: Mask R-CNN R50 + AR-FPN (config #5a)
MASK_CFG = os.path.join(_CONFIGS, 'arfe', 'mask_rcnn_r50_arfpn_1x_coco.py')
#: Cascade R-CNN R50 + AR-FPN (config #5b) and RetinaNet R50 + AR-FPN
#: (config #2)
CASCADE_CFG = os.path.join(_CONFIGS, 'arfe',
                           'cascade_rcnn_r50_arfpn_1x_coco.py')
RETINA_CFG = os.path.join(_CONFIGS, 'arfe', 'retinanet_r50_arfpn_1x_coco.py')
#: Libra R-CNN + ARFE at R50 and R101 (its balanced samplers, balanced L1
#: and AR-FPN at refine level 3), and Libra RetinaNet with its BFP neck
LIBRA_CFG = os.path.join(_CONFIGS, 'libra_rcnn',
                         'libra_faster_rcnn_r50_fpn_1x_coco.py')
LIBRA101_CFG = os.path.join(_CONFIGS, 'libra_rcnn',
                            'libra_faster_rcnn_r101_fpn_1x_coco.py')
LIBRA_RETINA_CFG = os.path.join(_CONFIGS, 'libra_rcnn',
                                'libra_retinanet_r50_fpn_1x_coco.py')
#: Faster R-CNN R50 + FPN with OHEM's sampler, and with the BFP neck
OHEM_CFG = os.path.join(_CONFIGS, 'faster_rcnn',
                        'faster_rcnn_r50_fpn_ohem_1x_coco.py')
BFP_CFG = os.path.join(_CONFIGS, 'faster_rcnn',
                       'faster_rcnn_r50_fpn_bfp_1x_coco.py')
#: Faster R-CNN R50 caffe + FPN (BGR input, ``Normalize(to_rgb=False)``)
CAFFE_CFG = os.path.join(_CONFIGS, 'faster_rcnn',
                         'faster_rcnn_r50_caffe_fpn_1x_coco.py')
#: Libra R-CNN + ARFE on ResNeXt-101 64x4d
LIBRA_X101_CFG = os.path.join(_CONFIGS, 'libra_rcnn',
                              'libra_faster_rcnn_x101_64x4d_fpn_1x_coco.py')
#: the C4 layout: caffe ResNet-50 to stage 3, one stride-16 level, RoIAlign
#: at 14 x 14 over 1024 channels, the shared ResLayer head (layer4)
C4_MASK_CFG = os.path.join(_CONFIGS, 'mask_rcnn',
                           'mask_rcnn_r50_caffe_c4_1x_coco.py')
C4_CFG = os.path.join(_CONFIGS, 'faster_rcnn',
                      'faster_rcnn_r50_caffe_c4_1x_coco.py')
#: Cascade Mask R-CNN R50 + FPN (a mask head a stage; serves boxes)
CASCADE_MASK_CFG = os.path.join(_CONFIGS, 'cascade_rcnn',
                                'cascade_mask_rcnn_r50_fpn_1x_coco.py')
#: Mask R-CNN R50 caffe + FPN as mmdet 1.x trained it (the legacy +1 box
#: coder, RoIAlign with ``sample_num=2``)
MASK_V1_CFG = os.path.join(_CONFIGS, 'mask_rcnn',
                           'mask_rcnn_r50_caffe_fpn_poly_1x_coco_v1.py')
#: the region proposal network alone, over the FPN's levels and over C4's
#: one stride-16 level; FSAF
RPN_CFG = os.path.join(_CONFIGS, 'rpn', 'rpn_r50_fpn_1x_coco.py')
RPN_C4_CFG = os.path.join(_CONFIGS, 'rpn', 'rpn_r50_caffe_c4_1x_coco.py')
FSAF_CFG = os.path.join(_CONFIGS, 'fsaf', 'fsaf_r50_fpn_1x_coco.py')
#: Faster R-CNN R50 + FPN with the GIoU loss in the RoI head; with the
#: authors' experimental necks (FPNBU, FPN + FPNRelation, FPNCBAM with
#: AR-RFF's triple RoIs); with AttRoIs' cross-RoI attention head (its
#: config declares 80 classes); and the VisDrone "+fac" detector (12
#: classes, the train set a list of two)
GIOU_CFG = os.path.join(_CONFIGS, 'faster_rcnn',
                        'faster_rcnn_r50_fpn_giou_1x_coco.py')
FPNBU_CFG = os.path.join(_CONFIGS, 'arfe', 'faster_rcnn_r50_fpn_bu_1x_coco.py')
RELATION_CFG = os.path.join(_CONFIGS, 'arfe',
                            'faster_rcnn_r50_fpn_relation_1x_coco.py')
CBAM_CFG = os.path.join(_CONFIGS, 'mytrain',
                        'faster_rcnn_r50_fpn_cbam_1x_coco.py')
ATT_CFG = os.path.join(_CONFIGS, 'faster_rcnn',
                       'faster_rcnn_r50_fpn_att_1x_visdrone.py')
VISDRONE_CFG = os.path.join(_CONFIGS, 'mytrain',
                            'faster_rcnn_r50_fpn_multicls_1x_visdrone.py')
H, W = 800, 1344             # the bench's padded image (bench.py:28)
IMG_SHAPE = (800.0, 1333.0)  # its content shape (bench.py:90)
BATCH_KEYS = ('img', 'img_shape', 'gt_bboxes', 'gt_valid', 'gt_labels')

# card against CPU: each loss within LOSS_RTOL + 4x the CPU's own spread
# (one thread against all), relative; each parameter's largest gradient
# difference within GRAD_RTOL of its largest |g|. At random weights the step
# is sensitive to rounding (the unscaled AR-FPN attention logits reach
# hundreds): two summation orders of the same f32 step differ by up to ~1e-2
# of a parameter's largest gradient. A wrong kernel differs by O(1). After a
# few steps at full width some parameters' spread can pass the limit, so
# compare seeded weights, which give the same reading in every run.
LOSS_RTOL = 1e-4
GRAD_RTOL = 5e-2
# OHEM's hard scores (classification losses of every candidate) on the card
# against the CPU: within HARD_RTOL of their largest + 4x the CPU's own
# spread (one thread against all)
HARD_RTOL = 1e-4


def synthetic_batch(b, h=H, w=W, img_shape=IMG_SHAPE, dtype=torch.bfloat16,
                    seed=0, g=16, device='cuda', masks=False):
    """The bench's training batch (``bench.py:170-188``): 8 gt boxes of
    30-80 px per image, padded to ``g``, labels 0-79, random (h, w) images
    whose content is ``img_shape``, and with ``masks`` random binary 28 x 28
    ``gt_mask_crops``; drawn from a numpy seed."""
    r = np.random.RandomState(seed)
    gt = np.zeros((b, g, 4), np.float32)
    valid = np.zeros((b, g), bool)
    labels = np.zeros((b, g), np.int64)
    for i in range(b):
        xy = r.uniform(0, [w - 80, h - 80], (8, 2))
        gt[i, :8] = np.concatenate([xy, xy + r.uniform(30, 80, (8, 2))], -1)
        valid[i, :8] = True
        labels[i, :8] = r.randint(0, 80, 8)
    img = torch.from_numpy((r.randn(b, h, w, 3) * 0.2).astype(np.float32))
    batch = dict(img=img.to(dtype), img_shape=torch.tensor([img_shape] * b),
                 gt_bboxes=torch.from_numpy(gt),
                 gt_valid=torch.from_numpy(valid),
                 gt_labels=torch.from_numpy(labels))
    if masks:
        batch['gt_mask_crops'] = torch.from_numpy(
            (r.rand(b, g, 28, 28) > 0.5).astype(np.float32))
    return {k: v.to(device) for k, v in batch.items()}


def refine_block(model):
    """The neck's NonLocal2D refine (AR-FPN's or BFP's), or None."""
    from ..ops.non_local import NonLocal2D
    return next((m for m in model.modules() if isinstance(m, NonLocal2D)),
                None)


def step_launches(model):
    """The kernel launches (A, B, C) of one training step: A once where the
    neck has a NonLocal refine; B and C once per RoI extraction (a cascade
    mask head's included), and B once more for OHEM's hard-mining forward
    over every candidate, which takes no gradient."""
    mining = any(s.needs_hard_scores for s in model.roi_samplers)
    n = model.num_step_extractions
    return int(refine_block(model) is not None), n + mining, n


def build_trainer(cfg=FLAGSHIP_CFG, device='cuda', seed=1):
    """``(model, optimizer, scheduler, frozen_prefixes)``: the detector of
    ``cfg`` with its ``train_cfg`` and seeded random weights, its NonLocal
    ``conv_out`` (zero at init; where the neck has one) made nonzero so the
    attention's gradient path is live, and the bench's optimizer: SGD lr
    0.02, momentum 0.9, weight decay 1e-4, linear warmup over 500
    iterations from ratio 0.001, the config's ``frozen_stages``."""
    from ..apis import init_detector
    model = init_detector(cfg, device=device, train=True)
    gen = torch.Generator().manual_seed(seed)
    refine = refine_block(model)
    with torch.no_grad():
        if refine is not None:
            w = refine.conv_out.conv.weight
            w.copy_(torch.randn(w.shape, generator=gen) * 0.01)
    sched = build_lr_schedule(
        dict(policy='step', warmup='linear', warmup_iters=500,
             warmup_ratio=0.001, step=[8, 11]), 0.02, 1000)
    frozen = frozen_prefixes_from_cfg(model.cfg.todict()['model'])
    opt, scheduler = build_optimizer(
        dict(type='SGD', lr=0.02, momentum=0.9, weight_decay=0.0001), sched,
        model, frozen)
    return model, opt, scheduler, frozen


def num_anchors(model, h, w):
    """Anchors of the dense head's table for an (h, w) image."""
    gen = model.dense_head.anchor_generator
    return sum(n * -(-h // s[1]) * -(-w // s[0])
               for s, n in zip(gen.strides, gen.num_base_anchors))


def _drawing(sampler):
    """The samplers whose draws ``sampler`` ranks: a combined sampler's
    positive and negative ones, else itself."""
    if hasattr(sampler, 'pos_sampler'):
        return [sampler.pos_sampler, sampler.neg_sampler]
    return [sampler]


def sampled_candidates(model, num_gts, h, w):
    """Each sampler that draws, with the candidates it draws among: the
    dense head's over its anchors (none for a pseudo sampler), then each
    RoI head stage's over its gts (when it adds them) and proposals, or a
    cascade's later stage's over its gts and the previous stage's
    samples. A combined sampler's two samplers come in its place."""
    head = model.dense_head
    out = [(head.sampler, num_anchors(model, h, w))] if head.sampling \
        else []
    if model.roi_samplers:
        n = model.train_cfg['rpn_proposal']['nms_post']
        for sampler in model.roi_samplers:
            m = n + num_gts * sampler.add_gt_as_proposals
            out += [(s, m) for s in _drawing(sampler)]
            n = getattr(sampler, 'num', m)
    return out


def fix_priorities(model, num_gts, h, w, seed=5):
    """The same sampling draws on every model: each sampler's uniform draws
    (``_uniform``, one set for the positives and one for the negatives)
    come from a seeded CPU generator for its candidates
    (:func:`sampled_candidates`), ``inf`` where a box is not a candidate.
    The priorities are still built from them as each sampler builds them:
    instance-balanced positives rank within their gts, IoU-balanced
    negatives within their IoU bins, OHEM's by their hard scores."""
    gen = torch.Generator().manual_seed(seed)
    for sampler, n in sampled_candidates(model, num_gts, h, w):
        draws = {side: torch.rand(n, generator=gen)
                 for side in ('pos', 'neg')}

        def fixed(g, cand, side, draws=draws):
            return torch.where(cand, draws[side].to(cand.device),
                               float('inf'))
        sampler._uniform = fixed


def loss_and_grads(model, batch, seed=5, hard_scores=None, seen=None,
                   chosen=None, rpn_seen=None):
    """Losses and parameter gradients (on the CPU) of one ``forward_train``
    + backward on the model's device, with the fixed sampling draws. For a
    model whose RoI sampler takes OHEM's hard scores, the scores it
    computes, the candidates' assignment and their boxes are appended to
    ``seen`` (on the CPU), and ``hard_scores``, where given, rank the
    candidates in their place. The RPN's inputs and its own choice of
    proposals, ``(shared features, image shapes, cfg, proposals,
    validity)``, are appended to ``rpn_seen``, and ``chosen`` (B, P), where
    given, replaces that choice: the proposals are then those candidates
    (:func:`chosen_candidates`) decoded from this model's own regressions,
    with their gradient (:func:`proposals_at`)."""
    dev = next(model.parameters()).device
    _, h, w, _ = batch['img'].shape
    fix_priorities(model, batch['gt_bboxes'].shape[1], h, w, seed)
    model.zero_grad(set_to_none=True)
    crops = batch.get('gt_mask_crops')
    rpn = getattr(model, 'rpn_head', None)
    if rpn is not None:
        # another caller's wrapper (tools/step_conditioning.py) stays inside
        own = vars(rpn).get('get_proposals')
        get_proposals = rpn.get_proposals

        def choose(feats, img_shapes, cfg=None, shared=None):
            dets, valid = get_proposals(feats, img_shapes, cfg, shared)
            if rpn_seen is not None:
                rpn_seen.append((shared, img_shapes, cfg, dets.detach(),
                                 valid))
            if chosen is None:
                return dets, valid
            return proposals_at(rpn, rpn_candidates(rpn, shared),
                                chosen.to(dev), img_shapes)
        rpn.get_proposals = choose
    mining = any(s.needs_hard_scores for s in model.roi_samplers)
    if mining:
        head = model.roi_head
        scores = head._candidate_hard_scores

        def shared(feats, boxes, assigned, gt_labels):
            own = scores(feats, boxes, assigned, gt_labels)
            if seen is not None:
                seen.append((own.cpu(), assigned.cpu(), boxes.cpu()))
            return own if hard_scores is None else hard_scores.to(own.device)
        head._candidate_hard_scores = shared
    try:
        total, logs = parse_losses(model.forward_train(
            *[batch[k].to(dev) for k in BATCH_KEYS], None,
            gt_mask_crops=None if crops is None else crops.to(dev)))
        total.backward()
    finally:
        if rpn is not None:
            if own is None:
                del rpn.get_proposals
            else:
                rpn.get_proposals = own
        if mining:
            del head._candidate_hard_scores
    return ({k: log_value(v) for k, v in logs.items()},
            {k: p.grad.detach().cpu().clone()
             for k, p in model.named_parameters() if p.grad is not None})


def log_value(v):
    """A logged value on the host: a float, or a tuple of floats for a
    vector (FSAF's ``gt_assign_hist``)."""
    v = v.detach().float()
    return float(v) if v.numel() == 1 else tuple(v.cpu().tolist())


def rpn_candidates(rpn, shared):
    """Each level's candidates as ``RPNHead.get_proposals`` ranks them, from
    the shared features: (logits (B, n), regressions (B, 4, n), anchors
    (n, 4)) in (anchor, position) order."""
    mlvl_anchors = rpn.anchor_generator.grid_anchors(
        [tuple(x.shape[2:]) for x in shared])
    return [rpn._level_candidates(x, a) for x, a in zip(shared, mlvl_anchors)]


def proposals_at(rpn, levels, inds, img_shapes):
    """The proposals (B, P, 5) of the candidates ``inds`` (B, P), indices
    into the :func:`rpn_candidates` ``levels`` one level after the other (-1
    for padding, [0, 0, 0, 0, -1]), decoded and scored as
    ``RPNHead.get_proposals`` does, and their (B, P) validity."""
    logits = torch.cat([c[0] for c in levels], 1)
    preds = torch.cat([c[1] for c in levels], 2).transpose(1, 2)
    anchors = torch.cat([c[2] for c in levels])
    valid = inds >= 0
    safe = inds.clamp(min=0)
    boxes = rpn.bbox_coder.decode(
        anchors[safe], torch.gather(preds, 1, safe[..., None].expand(
            *safe.shape, 4)), max_shape=img_shapes)
    dets = torch.cat([boxes, torch.sigmoid(
        torch.gather(logits, 1, safe))[..., None]], -1)
    return (torch.where(valid[..., None], dets,
                        dets.new_tensor([0., 0., 0., 0., -1.])), valid)


def match_proposals(dets, valid, other, other_valid, tol=1e-2):
    """For each of the proposals ``dets`` (B, P, 5), the index of a valid
    proposal of ``other`` (B, Q, 5) with every corner within ``tol`` pixels
    and the score within ``tol`` / 1000; -1 where there is none or the slot
    is padding (``valid`` (B, P) false). On the CPU."""
    dets, valid, other, other_valid = (t.detach().cpu() for t in (
        dets, valid, other, other_valid))
    scale = dets.new_tensor([1., 1., 1., 1., 1e3])
    out = torch.full(valid.shape, -1, dtype=torch.long)
    for b in range(dets.shape[0]):
        q = torch.nonzero(other_valid[b]).squeeze(1)
        if len(q) == 0:
            continue
        ref = other[b, q] * scale
        for s in range(0, dets.shape[1], 256):
            d, j = torch.cdist(dets[b, s:s + 256] * scale, ref,
                               p=float('inf')).min(1)
            out[b, s:s + 256] = torch.where(
                valid[b, s:s + 256] & (d <= tol), q[j], -1)
    return out


def unmatched(dets, valid, other, other_valid):
    """How many valid proposals of ``dets`` have none in ``other`` at the
    same box and score (:func:`match_proposals`), over the batch."""
    return int(((match_proposals(dets, valid, other, other_valid) < 0)
                & valid.cpu()).sum())


def chosen_candidates(rpn, seen):
    """The candidate of each of an RPN's proposals, an entry of
    :func:`loss_and_grads`' ``rpn_seen``, found by value among that RPN's
    :func:`rpn_candidates` on the same features: (B, P) indices for
    :func:`proposals_at`, -1 for padding."""
    shared, img_shapes, _, dets, valid = seen
    with torch.no_grad():
        levels = rpn_candidates(rpn, shared)
        b, n = len(dets), sum(c[0].shape[1] for c in levels)
        every, _ = proposals_at(rpn, levels, torch.arange(
            n, device=dets.device).expand(b, n), img_shapes)
    inds = match_proposals(dets, valid, every,
                           torch.ones(b, n, dtype=torch.bool))
    if ((inds < 0) & valid.cpu()).any():
        raise RuntimeError('a proposal is none of its RPN\'s candidates')
    return inds


def selection_faults(rpn, cpu_rpn, seen):
    """The card's selection of proposals held against the plain path's: the
    card RPN's own choice ``seen``, an entry of :func:`loss_and_grads`'
    ``rpn_seen``, against what ``cpu_rpn``'s ``get_proposals`` (top
    ``nms_pre`` a level, decode, NMS, top ``nms_post``) chooses on the CPU
    from the same candidates, the card's logits and regressions. Two
    different sets of numbers rightly choose differently where two scores
    or an overlap tie within rounding, which at random weights some do;
    on the same candidates only the decode's rounding differs, so a correct
    selection differs in none. Returns how many proposals of either choice
    the other lacks."""
    shared, img_shapes, cfg, dets, valid = seen
    with torch.no_grad():
        levels = iter([tuple(t.cpu() for t in c)
                       for c in rpn_candidates(rpn, shared)])
    cpu_rpn._level_candidates = lambda x, anchors: next(levels)
    try:
        want, want_valid = cpu_rpn.get_proposals(
            None, img_shapes.cpu(), cfg,
            [torch.empty(x.shape[0], 0, *x.shape[2:]) for x in shared])
    finally:
        del cpu_rpn._level_candidates
    return (unmatched(dets, valid, want, want_valid)
            + unmatched(want, want_valid, dets, valid))


def differences(a, b):
    """Each loss's relative difference, and the largest gradient difference
    of a parameter over its largest |g| (plus 1e-6 of the largest |g| of
    all, for gradients that are 0 in exact arithmetic, such as the NonLocal
    ``phi`` bias, which shifts each row's logits by a constant), with that
    parameter's name."""
    (la, ga), (lb, gb) = a, b
    va, vb = ({k: np.atleast_1d(v) for k, v in x.items()} for x in (la, lb))
    losses = {k: float(np.abs(va[k] - vb[k]).max())
              / max(float(np.abs(va[k]).max()), 1e-12) for k in la}
    floor = 1e-6 * max(g.abs().max().item() for g in ga.values())
    grads = max(((ga[k] - gb[k]).abs().max().item()
                 / (ga[k].abs().max().item() + floor), k) for k in ga)
    return losses, grads


def _hard_reading(sampler, cpu_seen, other_seen):
    """Another run's OHEM hard scores against the CPU's: the largest
    difference over the candidates whose boxes agree within 0.01 px (the
    others are proposals that the two runs' RPNs chose differently), how
    many do not agree, and how many candidates that run's own scores would
    have sampled that the CPU's did not (over the batch)."""
    (want, assigned, boxes), (got, _, other) = cpu_seen[0], other_seen[0]
    same = (other - boxes).abs().amax(dim=-1) <= 0.01
    err = (got - want).abs()[same].max().item()
    a = sampler.sample(None, assigned, hard_scores=want)
    b = sampler.sample(None, assigned, hard_scores=got)
    flips = sum(len(set(a['inds'][i][a['valid'][i]].tolist())
                    - set(b['inds'][i][b['valid'][i]].tolist()))
                for i in range(assigned.shape[0]))
    return err, int((~same).sum()), flips


def compare_with_cpu(model, cpu, batch, seed=5):
    """One f32 ``forward_train`` + backward of ``batch`` on ``model`` (the
    card) and on ``cpu`` (the same weights, plain path), and once more on
    the CPU with one thread, all with the same sampling draws and on the
    CPU's choice of proposals: each run's RPN ranks and suppresses its own
    scores, and where two scores or an overlap tie within f32 rounding (at
    random weights some do) its top-k or NMS keeps another anchor, which
    moves the RoI head's candidates and with them every loss and gradient
    after it. So the card and the one-thread CPU decode the CPU's
    candidates from their own regressions (:func:`chosen_candidates`), and
    the card's own choice is held apart, against the plain path's selection
    from the card's candidates (:func:`selection_faults`, which must find
    none); how many of the CPU's proposals each run's own choice lacks is
    reported. With an OHEM sampler each run computes its hard scores, which
    are held against the CPU's, and then all three rank the candidates by
    the CPU's: a difference of f32 rounding would otherwise swap near-ties
    in the ranking and with them the sampled RoIs.

    Returns a dict: ``loss_err`` and ``loss_spread`` (per loss, relative;
    card against CPU, and the CPU with one thread against all), ``grad_err``
    and ``grad_spread`` (``(largest relative difference, parameter)``),
    ``params`` (how many parameters have a gradient), ``same_params``,
    ``cpu_s``, ``threads``, ``ok`` under ``LOSS_RTOL`` / ``GRAD_RTOL`` (and
    ``HARD_RTOL``), ``cpu``, the CPU's :func:`loss_and_grads`; with an RPN
    ``selection_faults`` and ``other_proposals`` (for the one-thread CPU
    and the card, how many of the CPU's proposals their own RPN did not
    choose); and with OHEM ``hard``: the scores' largest value, and for the
    card and the one-thread CPU their scores' largest difference from the
    CPU's over the candidates with the CPU's boxes, how many candidates have
    other boxes, and how many sampled candidates their own scores would
    have changed.
    """
    t0 = time.time()
    cpu_seen, alt_seen, card_seen = [], [], []
    rpn_seen = [[], [], []]
    want = loss_and_grads(cpu, batch, seed, seen=cpu_seen,
                          rpn_seen=rpn_seen[0])
    cpu_s = time.time() - t0
    hard = cpu_seen[0][0] if cpu_seen else None
    chosen = (chosen_candidates(cpu.rpn_head, rpn_seen[0][0])
              if rpn_seen[0] else None)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        alt = loss_and_grads(cpu, batch, seed, hard, alt_seen, chosen,
                             rpn_seen[1])
    finally:
        torch.set_num_threads(threads)
    got = loss_and_grads(model, batch, seed, hard, card_seen, chosen,
                         rpn_seen[2])
    loss_spread, grad_spread = differences(want, alt)
    loss_err, grad_err = differences(want, got)
    same = sorted(got[1]) == sorted(want[1])
    ok = (all(loss_err[k] <= LOSS_RTOL + 4 * loss_spread[k]
              for k in loss_err)
          and grad_err[0] <= GRAD_RTOL and same and len(want[1]) > 100)
    out = dict(loss_err=loss_err, loss_spread=loss_spread,
               grad_err=grad_err, grad_spread=grad_spread,
               params=len(want[1]), same_params=same, cpu_s=cpu_s,
               threads=threads, cpu=want)
    if chosen is not None:
        props = rpn_seen[0][0][3:]
        out['other_proposals'] = [unmatched(*props, *r[0][3:])
                                  for r in rpn_seen[1:]]
        out['selection_faults'] = selection_faults(
            model.rpn_head, cpu.rpn_head, rpn_seen[2][0])
        ok = ok and out['selection_faults'] == 0
    if hard is not None:
        sampler = cpu.roi_head.sampler
        card_err, card_moved, card_flips = _hard_reading(sampler, cpu_seen,
                                                         card_seen)
        spread, spread_moved, spread_flips = _hard_reading(sampler, cpu_seen,
                                                           alt_seen)
        top = hard.abs().max().item()
        out['hard'] = dict(max=top, err=card_err, moved=card_moved,
                           flips=card_flips, spread=spread,
                           spread_moved=spread_moved,
                           spread_flips=spread_flips)
        ok = ok and card_err <= HARD_RTOL * top + 4 * spread
    out['ok'] = ok
    return out
