"""The training slice as a whole on the CPU: the tiny flagship Faster R-CNN +
AR-FPN (R18, 64 channels, 64 proposals, 128x160, as
``__graft_entry__._build_flagship(tiny=True)``) in the port against the JAX
package, with the same weights (the port's seeded ones as a JAX parameter
tree, ``test_torch_detector.port_params``), images and ground truth.

``jax.random`` and ``torch.Generator`` draw different numbers, so both sides'
samplers get the same numpy-drawn priorities: ``_pos_priority`` /
``_neg_priority`` of the RPN's and the RoI head's sampler are replaced on the
instances, with ``inf`` where a box is not a candidate.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_detector import FAST_COMPILE, _perturb, port_params, tiny_cfg
from test_torch_threads import one_torch_thread  # noqa: F401

from __graft_entry__ import _build_flagship
from arfe_tpu.core.bbox.coder import bbox2delta as j_bbox2delta
from arfe_tpu.models import losses as jl
from arfe_tpu.models.dense_heads.anchor_head import \
    anchor_inside_flags as j_anchor_inside_flags
from arfe_tpu.train import parse_losses as j_parse_losses
from arfe_tpu_torch.convert import params_to_state_dict
from arfe_tpu_torch.core.bbox import bbox2delta
from arfe_tpu_torch.models import build_detector
from arfe_tpu_torch.models import losses as tl
from arfe_tpu_torch.models.dense_heads.anchor_head import anchor_inside_flags
from arfe_tpu_torch.train import (build_lr_schedule, build_optimizer,
                                  frozen_prefixes_from_cfg, make_train_step,
                                  parse_losses)

B, H, W, G, P = 2, 128, 160, 16, 64
SHAPES = np.array([[128., 150.], [120., 160.]], np.float32)
LOSS_NAMES = ['loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls', 'acc',
              'loss_bbox', 'loss']


def tiny_train_cfg():
    """:func:`tiny_cfg` with the training sizes of the tiny flagship."""
    cfg = tiny_cfg()
    tc = cfg['train_cfg']
    tc['rpn']['sampler']['num'] = 64
    tc['rpn_proposal'].update(nms_pre=100, nms_post=64, max_num=64)
    tc['rcnn']['sampler']['num'] = 64
    return cfg


def _ground_truth(rng):
    """5 and 3 boxes of 15-60 px, padded to G; image 0 repeats its box 1 as
    box 5, so that the later of two equal gts takes their best anchors."""
    gt = np.zeros((B, G, 4), np.float32)
    valid = np.zeros((B, G), bool)
    labels = np.zeros((B, G), np.int32)
    for i, n in enumerate((5, 3)):
        xy = rng.uniform(0, [W - 60, H - 60], (n, 2))
        wh = rng.uniform(15, 60, (n, 2))
        gt[i, :n] = np.concatenate([xy, xy + wh], -1)
        valid[i, :n] = True
        labels[i, :n] = rng.randint(0, 80, n)
    gt[0, 5], valid[0, 5], labels[0, 5] = gt[0, 1], True, 7
    return gt, valid, labels


def _proposals(rng, gt, valid):
    """(B, P, 5) candidate boxes: gts jittered by a few px, and random boxes;
    the last 8 of each image invalid."""
    props = np.zeros((B, P, 5), np.float32)
    for i in range(B):
        src = gt[i][valid[i]]
        near = src[rng.randint(0, len(src), P // 2)] \
            + rng.uniform(-6, 6, (P // 2, 4))
        xy = rng.uniform(0, [W - 20, H - 20], (P - P // 2, 2))
        far = np.concatenate([xy, xy + rng.uniform(8, 70, xy.shape)], -1)
        props[i, :, :4] = np.concatenate([near, far])
        props[i, :, 4] = rng.uniform(size=P)
    pvalid = np.ones((B, P), bool)
    pvalid[:, -8:] = False
    return props, pvalid


def _patch_jax(sampler, pos, neg):
    pos, neg = jnp.asarray(pos), jnp.asarray(neg)
    sampler._pos_priority = lambda key, cand, ctx: jnp.where(cand, pos,
                                                             jnp.inf)
    sampler._neg_priority = lambda key, cand, ctx: jnp.where(cand, neg,
                                                             jnp.inf)


def _patch_torch(sampler, pos, neg):
    pos, neg = torch.from_numpy(pos), torch.from_numpy(neg)
    sampler._pos_priority = lambda gen, cand, ctx: torch.where(
        cand, pos, float('inf'))
    sampler._neg_priority = lambda gen, cand, ctx: torch.where(
        cand, neg, float('inf'))


class _RoIsWithoutGradient:
    """A JAX RoI extractor whose RoIs get no gradient."""

    def __init__(self, extractor):
        self.extractor = extractor

    def __getattr__(self, name):
        return getattr(self.extractor, name)

    def __call__(self, params, feats, rois, **kwargs):
        return self.extractor(params, feats, jax.lax.stop_gradient(rois),
                              **kwargs)


def stop_roi_gradient(jm):
    """The RoIs entering the JAX instance's extractor get no gradient, as in
    the JAX package's kernel path, whose VJP gives them zeros
    (``arfe_tpu/ops/pallas_roi_align.py:429,435``), and in the port. On the
    CPU the JAX package extracts with its plain ``roi_align_pyramid``, which
    differentiates them. The box targets' gradient through the proposals
    into ``rpn_reg`` stays on both sides."""
    head = jm.roi_head
    head.bbox_roi_extractor = _RoIsWithoutGradient(head.bbox_roi_extractor)


@pytest.fixture(scope='module')
def run():
    rng = np.random.RandomState(0)
    jm = _build_flagship(tiny=True)
    params = _perturb(port_params(), rng)
    gt, gvalid, glabels = _ground_truth(rng)
    img = (rng.randn(B, H, W, 3) * 0.2).astype(np.float32)
    props, pvalid = _proposals(rng, gt, gvalid)

    cfg = tiny_train_cfg()
    tm = build_detector(cfg['model'], train_cfg=cfg['train_cfg'],
                        test_cfg=cfg['test_cfg'])
    tm.load_state_dict(params_to_state_dict(params), strict=True)
    with torch.no_grad():
        sizes = [tuple(f.shape[2:]) for f in tm.extract_feat(
            torch.from_numpy(img))]
    num_anchors = sum(h * w for h, w in sizes) * tm.rpn_head.num_anchors
    prio = {'rpn': (rng.uniform(size=num_anchors).astype(np.float32),
                    rng.uniform(size=num_anchors).astype(np.float32)),
            'rcnn': (rng.uniform(size=G + P).astype(np.float32),
                     rng.uniform(size=G + P).astype(np.float32))}
    for m, patch in ((jm, _patch_jax), (tm, _patch_torch)):
        patch(m.rpn_head.sampler, *prio['rpn'])
        patch(m.roi_head.sampler, *prio['rcnn'])
    stop_roi_gradient(jm)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jargs = [jnp.asarray(x) for x in (img, SHAPES, gt, gvalid, glabels)]

    def loss_fn(p):
        return j_parse_losses(jm.forward_train(p, *jargs,
                                               jax.random.PRNGKey(0)))

    (_, jlogs), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                                 compiler_options=FAST_COMPILE)(jp)
    targs = [torch.from_numpy(x) for x in (img, SHAPES, gt, gvalid, glabels)]
    total, tlogs = parse_losses(tm.forward_train(
        *targs, torch.Generator().manual_seed(0)))
    total.backward()
    return dict(
        jm=jm, tm=tm, cfg=cfg, params=params, sizes=sizes, prio=prio,
        data=dict(img=img, gt=gt, gvalid=gvalid, glabels=glabels,
                  props=props, pvalid=pvalid),
        jlogs={k: float(v) for k, v in jlogs.items()},
        tlogs={k: float(v.detach()) for k, v in tlogs.items()},
        jgrads=params_to_state_dict(jax.tree_util.tree_map(np.array, jgrads)))


def _rpn_assign(run):
    """Both sides' RPN assignment over the (anchor, position) anchor table,
    computed once for the module's tests."""
    if 'rpn_assign' not in run:
        run['rpn_assign'] = _rpn_assign_once(run)
    return run['rpn_assign']


def _rpn_assign_once(run):
    jm, tm, d = run['jm'], run['tm'], run['data']
    janchors, jflags = jm.rpn_head._flat_anchor_table(run['sizes'],
                                                      anchor_major=True)
    tanchors, tflags = tm.rpn_head._flat_anchor_table(run['sizes'], 'cpu')
    border = tm.rpn_head.train_cfg['allowed_border']
    # one compiled program for both images (op by op, each op compiles)
    assign = jax.jit(lambda gt, gvalid, shape: jm.rpn_head.assigner.assign(
        janchors, gt, gvalid, box_valid=j_anchor_inside_flags(
            janchors, jflags, shape, border)), compiler_options=FAST_COMPILE)
    want = [assign(jnp.asarray(d['gt'][i]), jnp.asarray(d['gvalid'][i]),
                   jnp.asarray(SHAPES[i])) for i in range(B)]
    got = tm.rpn_head.assigner.assign(
        tanchors, torch.from_numpy(d['gt']), torch.from_numpy(d['gvalid']),
        box_valid=anchor_inside_flags(tanchors, tflags,
                                      torch.from_numpy(SHAPES), border))
    return (janchors, jflags, tanchors, tflags), want, got


def test_anchor_table_matches_jax(run):
    (janchors, jflags, tanchors, tflags), _, _ = _rpn_assign(run)
    np.testing.assert_array_equal(tanchors.numpy(), np.asarray(janchors))
    np.testing.assert_array_equal(tflags.numpy(), np.asarray(jflags))


@pytest.mark.parametrize('border', [0, 8, -1])
def test_anchor_inside_flags_match_jax(run, border):
    (janchors, jflags, tanchors, tflags), _, _ = _rpn_assign(run)
    got = anchor_inside_flags(tanchors, tflags, torch.from_numpy(SHAPES),
                              border)
    for i in range(B):
        want = j_anchor_inside_flags(janchors, jflags, SHAPES[i], border)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def test_rpn_assigner_matches_jax(run):
    _, want, got = _rpn_assign(run)
    inds = got['assigned_gt_inds'].numpy()
    for i in range(B):
        np.testing.assert_array_equal(inds[i],
                                      np.asarray(want[i]['assigned_gt_inds']))
        np.testing.assert_array_equal(got['max_overlaps'][i].numpy(),
                                      np.asarray(want[i]['max_overlaps']))
    assert (inds > 0).sum() > 10 and (inds == 0).any() and (inds < 0).any()
    # the repeated gt (index 5 of image 0) took over its twin's best anchors
    assert (inds[0] == 6).any() and not (inds[0] == 2).any()


def _rcnn_assign(run):
    """Both sides' RoI head assignment, computed once for the module's
    tests."""
    if 'rcnn_assign' not in run:
        run['rcnn_assign'] = _rcnn_assign_once(run)
    return run['rcnn_assign']


def _rcnn_assign_once(run):
    jm, tm, d = run['jm'], run['tm'], run['data']
    jargs = [jnp.asarray(d[k]) for k in ('props', 'pvalid', 'gt', 'gvalid',
                                         'glabels')]
    want = jax.jit(jax.vmap(jm.roi_head._assign_single),
                   compiler_options=FAST_COMPILE)(*jargs)
    got = tm.roi_head._assign(*[torch.from_numpy(d[k]) for k in (
        'props', 'pvalid', 'gt', 'gvalid')])
    return want, got


def test_rcnn_assigner_matches_jax(run):
    """Gts prepended as candidates (padded gts invalid), positives at IoU
    0.5 without low-quality matches."""
    want, got = _rcnn_assign(run)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    inds, gvalid = got[1].numpy(), run['data']['gvalid']
    assert (inds > 0).sum() > 8 and (inds == 0).any()
    assert (inds[:, :G][gvalid] > 0).all() and (inds[:, :G][~gvalid] == -1).all()


@pytest.mark.parametrize('head', ['rpn', 'rcnn'])
def test_sampler_matches_jax(run, head):
    """The same assignment and priorities give the same slots: selected
    positives first, then negatives, then invalid slots."""
    if head == 'rpn':
        _, want_assign, got_assign = _rpn_assign(run)
        jassigned = [w['assigned_gt_inds'] for w in want_assign]
        tassigned = got_assign['assigned_gt_inds']
        jsampler = run['jm'].rpn_head.sampler
        tsampler = run['tm'].rpn_head.sampler
    else:
        (_, jass, _), (_, tassigned, _) = _rcnn_assign(run)
        jassigned = list(jass)
        jsampler = run['jm'].roi_head.sampler
        tsampler = run['tm'].roi_head.sampler
    got = tsampler.sample(None, tassigned)
    sample = jax.jit(jsampler.sample, compiler_options=FAST_COMPILE)
    for i in range(B):
        want = sample(jax.random.PRNGKey(i), jassigned[i])
        for k in ('inds', 'is_pos', 'valid'):
            np.testing.assert_array_equal(got[k][i].numpy(),
                                          np.asarray(want[k]))
        pos = got['is_pos'][i].numpy()
        npos = pos.sum()
        assert npos > 0 and pos[:npos].all() and not pos[npos:].any()
        nvalid = got['valid'][i].numpy().sum()
        assert npos < nvalid <= tsampler.num
        assert got['valid'][i].numpy()[:nvalid].all()


def test_random_sampler_draws_from_generator():
    """Unpatched, the priorities come from the generator: the same seed
    gives the same slots, every slot is a candidate of its kind, and the
    positives stay within their quota."""
    cfg = tiny_train_cfg()
    tm = build_detector(cfg['model'], train_cfg=cfg['train_cfg'])
    sampler = tm.roi_head.sampler
    assigned = torch.from_numpy(
        np.random.RandomState(5).randint(-1, 4, (B, 300)))
    a = sampler.sample(torch.Generator().manual_seed(1), assigned)
    b = sampler.sample(torch.Generator().manual_seed(1), assigned)
    c = sampler.sample(torch.Generator().manual_seed(2), assigned)
    for k in ('inds', 'is_pos', 'valid'):
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a['inds'], c['inds'])
    picked = torch.gather(assigned, 1, a['inds'])
    assert bool((picked[a['is_pos']] > 0).all())
    assert bool((picked[a['valid'] & ~a['is_pos']] == 0).all())
    assert int(a['is_pos'].sum(1).max()) <= sampler.num * sampler.pos_fraction


@pytest.mark.parametrize('name', LOSS_NAMES)
def test_losses_match_jax(run, name):
    want, got = run['jlogs'][name], run['tlogs'][name]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_gradients_match_jax(run):
    """Every trainable parameter's gradient within 1e-4 + 1e-3 max|g| of
    ``jax.grad`` of the JAX ``forward_train`` + ``parse_losses``; ``rpn_reg``
    among them, which the box targets reach through the proposals."""
    jgrads = run['jgrads']
    checked, bad = 0, []
    for name, p in run['tm'].named_parameters():
        if not p.requires_grad:
            continue
        want = jgrads[name].numpy()
        got = p.grad.numpy()
        tol = 1e-4 + 1e-3 * np.abs(want).max()
        err = np.abs(got - want).max()
        if not err <= tol:
            bad.append((name, float(err), float(tol)))
        checked += 1
    assert checked > 100 and not bad, bad[:5]
    # the attention's gradient is live: the NonLocal projections have one
    theta = dict(run['tm'].named_parameters())[
        'neck.1.refine.theta.conv.weight']
    assert float(theta.grad.abs().max()) > 0


def test_proposals_carry_gradient_to_rpn_reg(run, monkeypatch):
    """The box targets' gradient through the proposals reaches ``rpn_reg``
    (as ``jax.grad`` has it, ``test_gradients_match_jax``): with the
    proposals detached, its gradient is another."""
    tm, d = run['tm'], run['data']
    args = [torch.from_numpy(d[k]) for k in ('img', 'gt', 'gvalid',
                                             'glabels')]
    args.insert(1, torch.from_numpy(SHAPES))
    get_proposals = tm.rpn_head.get_proposals
    monkeypatch.setattr(tm.rpn_head, 'get_proposals', lambda *a, **k: tuple(
        t.detach() for t in get_proposals(*a, **k)))
    saved = {k: p.grad for k, p in tm.named_parameters()}
    tm.zero_grad(set_to_none=True)
    total, _ = parse_losses(tm.forward_train(*args,
                                             torch.Generator().manual_seed(0)))
    total.backward()
    detached = tm.rpn_head.rpn_reg.weight.grad
    for k, p in tm.named_parameters():      # the other tests read them
        p.grad = saved[k]
    want = run['jgrads']['rpn_head.rpn_reg.weight']
    np.testing.assert_allclose(tm.rpn_head.rpn_reg.weight.grad.numpy(),
                               want.numpy(), atol=1e-4 + 1e-3 *
                               float(want.abs().max()))
    assert float((detached - want).abs().max()) > 1e-2 * float(
        want.abs().max())


def test_frozen_parameters_get_no_gradient(run):
    """``frozen_stages=1``: the stem and layer1 take no part in the
    backward, as the JAX package's ``stop_gradient`` leaves them at 0."""
    frozen = frozen_prefixes_from_cfg(run['cfg']['model'])
    assert frozen == ['backbone.conv1', 'backbone.bn1', 'backbone.layer1']
    names = []
    for name, p in run['tm'].named_parameters():
        if any(name.startswith(f) for f in frozen):
            assert not p.requires_grad and p.grad is None
            assert not run['jgrads'][name].any()
            names.append(name)
        else:
            assert p.requires_grad and p.grad is not None
    assert len(names) > 10


def test_train_step_updates_trainable_parameters_only(run):
    """One step of ``make_train_step`` with the flagship's SGD: the frozen
    stem and layer1 stay bit for bit, the others move, the logs are the
    losses and their total."""
    cfg = run['cfg']
    tm = build_detector(cfg['model'], train_cfg=cfg['train_cfg'],
                        test_cfg=cfg['test_cfg'])
    tm.load_state_dict(params_to_state_dict(run['params']))
    sched = build_lr_schedule(dict(policy='step', warmup='linear',
                                   warmup_iters=500, warmup_ratio=0.001,
                                   step=[8, 11]), 0.02, 1000)
    frozen = frozen_prefixes_from_cfg(cfg['model'])
    opt, scheduler = build_optimizer(
        dict(type='SGD', lr=0.02, momentum=0.9, weight_decay=0.0001), sched,
        tm, frozen)
    step = make_train_step(tm, opt, scheduler)
    d = run['data']
    batch = dict(img=torch.from_numpy(d['img']),
                 img_shape=torch.from_numpy(SHAPES),
                 gt_bboxes=torch.from_numpy(d['gt']),
                 gt_valid=torch.from_numpy(d['gvalid']),
                 gt_labels=torch.from_numpy(d['glabels']))
    before = {k: v.clone() for k, v in tm.named_parameters()}
    logs = step(batch, torch.Generator().manual_seed(0))
    assert sorted(logs) == sorted(LOSS_NAMES)
    assert all(bool(torch.isfinite(v)) for v in logs.values())
    moved = {k for k, v in tm.named_parameters()
             if not torch.equal(v, before[k])}
    trainable = {k for k in before if not any(k.startswith(f)
                                              for f in frozen)}
    # a tensor whose gradient is exactly 0 moves only by its weight decay,
    # so not at all where it is 0 (a bias behind a ReLU that never fires)
    zero_grad = {k for k, v in tm.named_parameters()
                 if k in trainable and not bool(v.grad.any())}
    assert moved <= trainable
    assert trainable - zero_grad <= moved, sorted(trainable - moved)
    assert len(zero_grad) < 0.1 * len(trainable), sorted(zero_grad)
    assert opt.param_groups[0]['lr'] == pytest.approx(sched(1))


def test_bbox2delta_matches_jax():
    rng = np.random.RandomState(7)
    xy = rng.uniform(0, 100, (50, 2))
    props = np.concatenate([xy, xy + rng.uniform(0, 40, (50, 2))], -1)
    props[:5, 2] = props[:5, 0]            # zero width: floored at 1e-6
    gts = np.concatenate([xy, xy + rng.uniform(1, 40, (50, 2))], -1)
    props, gts = props.astype(np.float32), gts.astype(np.float32)
    means, stds = (0., 0.1, 0., 0.), (0.1, 0.1, 0.2, 0.2)
    want = j_bbox2delta(jnp.asarray(props), jnp.asarray(gts), means, stds)
    got = bbox2delta(torch.from_numpy(props), torch.from_numpy(gts), means,
                     stds)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _loss_inputs(seed, n=40, c=5):
    rng = np.random.RandomState(seed)
    return dict(pred=rng.randn(n, c).astype(np.float32) * 3,
                label=rng.randint(0, c + 1, n).astype(np.int32),
                weight=(rng.uniform(size=n) > 0.3).astype(np.float32),
                target=rng.randn(n, c).astype(np.float32))


@pytest.mark.parametrize('reduction,avg', [('mean', None), ('mean', 13.0),
                                           ('sum', None), ('none', None)])
@pytest.mark.parametrize('kind', ['ce', 'bce_onehot', 'bce_single', 'l1',
                                  'smooth_l1'])
def test_loss_functions_match_jax(kind, reduction, avg):
    x = _loss_inputs(len(kind) * 10 + len(reduction))
    weight = x['weight']
    if kind == 'ce':
        args = (x['pred'], x['label'])
        fns = (jl.cross_entropy, tl.cross_entropy)
    elif kind == 'bce_onehot':       # class indices, 0 = background
        args = (x['pred'], x['label'])
        fns = (jl.binary_cross_entropy, tl.binary_cross_entropy)
    elif kind == 'bce_single':       # the RPN: one logit, 0/1 labels
        args = (x['pred'][:, 0], (x['label'] > 2).astype(np.float32))
        fns = (jl.binary_cross_entropy, tl.binary_cross_entropy)
    else:
        args = (x['pred'], x['target'])
        weight = np.broadcast_to(weight[:, None], x['pred'].shape).copy()
        cls = 'L1Loss' if kind == 'l1' else 'SmoothL1Loss'
        kw = {} if kind == 'l1' else dict(beta=1.0 / 9.0)
        fns = (getattr(jl, cls)(loss_weight=2.0, **kw),
               getattr(tl, cls)(loss_weight=2.0, **kw))
    jfn, tfn = fns
    if kind in ('l1', 'smooth_l1'):
        want = jfn(*[jnp.asarray(a) for a in args], jnp.asarray(weight),
                   avg_factor=avg, reduction_override=reduction)
        got = tfn(*[torch.from_numpy(a) for a in args],
                  torch.from_numpy(weight), avg_factor=avg,
                  reduction_override=reduction)
    else:
        want = jfn(*[jnp.asarray(a) for a in args], jnp.asarray(weight),
                   reduction=reduction, avg_factor=avg)
        got = tfn(*[torch.from_numpy(a) for a in args],
                  torch.from_numpy(weight), reduction=reduction,
                  avg_factor=avg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize('topk', [1, (1, 3)])
@pytest.mark.parametrize('masked', [False, True])
def test_accuracy_matches_jax(topk, masked):
    x = _loss_inputs(3, n=60, c=6)
    pred = np.round(x['pred'])            # ties: the lower class first
    mask = x['weight'] > 0 if masked else None
    want = jl.accuracy(jnp.asarray(pred), jnp.asarray(x['label']), topk,
                       None if mask is None else jnp.asarray(mask))
    got = tl.accuracy(torch.from_numpy(pred), torch.from_numpy(x['label']),
                      topk, None if mask is None else torch.from_numpy(mask))
    if topk == 1:
        got, want = [got], [want]
    np.testing.assert_allclose([float(v) for v in got],
                               [float(v) for v in want], rtol=1e-6)


def test_gradient_check_catches_a_dropped_corner(run, monkeypatch):
    """The card-against-CPU training check (``chip_smoke.py`` phase 6,
    ``tests/test_torch_gpu.py``) holds each parameter's gradient within 5e-2
    of its largest |g|, because rounding alone moves some by ~1e-2 at random
    weights. A RoIAlign backward that drops one of the four bilinear corners
    must still fail it."""
    from arfe_tpu_torch.ops import roi_align as ra
    from arfe_tpu_torch.train.bench import GRAD_RTOL, differences
    tm, d = run['tm'], run['data']
    args = [torch.from_numpy(d[k]) for k in ('img', 'gt', 'gvalid',
                                             'glabels')]
    args.insert(1, torch.from_numpy(SHAPES))

    def grads():
        tm.zero_grad(set_to_none=True)
        total, logs = parse_losses(tm.forward_train(*args, None))
        total.backward()
        return ({k: float(v.detach()) for k, v in logs.items()},
                {k: p.grad.clone() for k, p in tm.named_parameters()
                 if p.grad is not None})

    saved = {k: p.grad for k, p in tm.named_parameters()}
    want = grads()
    corners = ra.sample_corners
    backward = ra.roi_align_backward_plain

    def three_corners(*a, **k):
        monkeypatch.setattr(ra, 'sample_corners', lambda *x, **y: (
            corners(*x, **y)[0][:3], corners(*x, **y)[1]))
        try:
            return backward(*a, **k)
        finally:
            monkeypatch.setattr(ra, 'sample_corners', corners)

    monkeypatch.setattr(ra, 'roi_align_backward_plain', three_corners)
    got = grads()
    for k, p in tm.named_parameters():      # the other tests read them
        p.grad = saved[k]
    _, (worst, _) = differences(want, got)
    assert worst > GRAD_RTOL
