"""FSAF and the IoU losses in the port against the JAX package on the CPU:
the four IoU losses and their gradients, ``TBLRBBoxCoder``,
``CenterRegionAssigner`` with its dense ``shadowed_mat``, ``reg_decoded_bbox``
in ``AnchorHead``, the FSAF head's loss with its online level choice and
``gt_assign_hist``, and the tiny FSAF detector (``configs/fsaf/
fsaf_r50_fpn_1x_coco.py`` cut to R18 and 64 channels) served and trained.

Both sides start from the port's seeded weights, converted. FSAF samples
nothing, so no draws are shared.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_detector as det
import torch
from test_torch_arrff import FAST_COMPILE
from test_torch_cascade import detections_match
from test_torch_train import B, H, SHAPES, W, _ground_truth
from test_torch_threads import one_torch_thread  # noqa: F401

from arfe_tpu.config import Config as JConfig
from arfe_tpu.convert import state_dict_to_params
from arfe_tpu.core.bbox.assigners import \
    CenterRegionAssigner as JCenterRegionAssigner
from arfe_tpu.core.bbox.coder import TBLRBBoxCoder as JTBLRBBoxCoder
from arfe_tpu.models import build_detector as j_build_detector
from arfe_tpu.models.builder import build_head as j_build_head
from arfe_tpu.registry import LOSSES as J_LOSSES
from arfe_tpu.registry import build_from_cfg as j_build_from_cfg
from arfe_tpu.train import parse_losses as j_parse_losses
from arfe_tpu_torch.config import Config
from arfe_tpu_torch.convert import params_to_state_dict
from arfe_tpu_torch.core.bbox import CenterRegionAssigner, TBLRBBoxCoder
from arfe_tpu_torch.layers import init_weights
from arfe_tpu_torch.models import build_detector
from arfe_tpu_torch.models.builder import build_head
from arfe_tpu_torch.registry import LOSSES, build_from_cfg
from arfe_tpu_torch.train import parse_losses

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FSAF_CFG = os.path.join(REPO, 'configs', 'fsaf', 'fsaf_r50_fpn_1x_coco.py')


def _boxes(rng, n, lo=2.0, hi=60.0, span=150.0):
    xy = rng.uniform(0, span, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(lo, hi, (n, 2))],
                          -1).astype(np.float32)


# --------------------------------------------------------------------------
# the IoU losses
# --------------------------------------------------------------------------

LOSS_CLASSES = ['IoULoss', 'GIoULoss', 'AIoULoss', 'BoundedIoULoss']
WEIGHTS = [None, 'box', 'row']
REDUCTIONS = [('mean', None), ('mean', 23.0), ('sum', None), ('none', None)]


def _loss_kwargs(name):
    return dict(loss_weight=2.0, beta=0.3) if name == 'BoundedIoULoss' \
        else dict(loss_weight=2.0)


def _iou_inputs(name, weight):
    """Boxes that overlap, nest, touch and miss, degenerate ones among them
    (the RoI head feeds the losses deltas), and (n, 4), (n,) or no
    weights."""
    rng = np.random.RandomState(LOSS_CLASSES.index(name))
    target = _boxes(rng, 48)
    pred = target + rng.uniform(-12, 12, target.shape).astype(np.float32)
    pred[:8] = rng.uniform(-1, 1, (8, 4))           # delta-like, unordered
    pred[8:12] = target[8:12]                       # exact
    w = {None: None, 'box': rng.uniform(0, 1, (48, 4)),
         'row': rng.uniform(0, 1, 48)}[weight]
    return pred, target, None if w is None else w.astype(np.float32)


@pytest.fixture(scope='module')
def iou_references():
    """Every case's JAX loss, and for the unreduced ones its gradient with
    respect to ``pred`` (a reduction scales it), in one compiled program
    (op by op, each op compiles)."""
    def all_cases():
        out = {}
        for name in LOSS_CLASSES:
            loss = j_build_from_cfg(dict(type=name, **_loss_kwargs(name)),
                                    J_LOSSES)
            for weight in WEIGHTS:
                pred, target, w = (None if x is None else jnp.asarray(x)
                                   for x in _iou_inputs(name, weight))
                for reduction, avg in REDUCTIONS:
                    def value(p):
                        return loss(p, target, w, avg_factor=avg,
                                    reduction_override=reduction)
                    out[f'{name} {weight} {reduction} {avg}'] = (
                        value(pred), jax.grad(lambda p: value(p).sum())(pred)
                        if reduction == 'none' else value(pred))
        return out
    return jax.jit(all_cases, compiler_options=FAST_COMPILE)()


@pytest.mark.parametrize('name', LOSS_CLASSES)
@pytest.mark.parametrize('weight', WEIGHTS)
@pytest.mark.parametrize('reduction,avg', REDUCTIONS)
def test_iou_loss_matches_jax(iou_references, name, weight, reduction, avg):
    """Each loss class with each weighting, each reduction and an
    ``avg_factor``: the value within rtol 1e-4 of the JAX package's; and,
    unreduced, its gradient with respect to ``pred`` within 1e-4 + 1e-3 of
    the largest."""
    pred, target, w = _iou_inputs(name, weight)
    ours = build_from_cfg(dict(type=name, **_loss_kwargs(name)), LOSSES)
    want, jgrad = (np.asarray(x) for x in
                   iou_references[f'{name} {weight} {reduction} {avg}'])
    tp = torch.from_numpy(pred).requires_grad_()
    got = ours(tp, torch.from_numpy(target),
               None if w is None else torch.from_numpy(w), avg_factor=avg,
               reduction_override=reduction)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-6)
    if reduction == 'none':
        got.sum().backward()
        tol = 1e-4 + 1e-3 * np.abs(jgrad).max()
        np.testing.assert_allclose(tp.grad.numpy(), jgrad, rtol=0, atol=tol)


def test_tblr_coder_matches_jax():
    """Encode and decode (clamped to each image and not) within 1e-5 of the
    JAX coder's, and decode inverts encode."""
    rng = np.random.RandomState(4)
    anchors, gts = _boxes(rng, 60), _boxes(rng, 60)
    ours, theirs = TBLRBBoxCoder(normalizer=4.0), JTBLRBBoxCoder(4.0)
    enc = ours.encode(torch.from_numpy(anchors), torch.from_numpy(gts))
    np.testing.assert_allclose(
        enc.numpy(), np.asarray(theirs.encode(jnp.asarray(anchors),
                                              jnp.asarray(gts))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        ours.decode(torch.from_numpy(anchors), enc).numpy(), gts, rtol=1e-5,
        atol=1e-4)
    preds = rng.uniform(0, 1.5, (B, 60, 4)).astype(np.float32)
    got = ours.decode(torch.from_numpy(anchors),
                      torch.from_numpy(preds), torch.from_numpy(SHAPES))
    for i in range(B):
        want = theirs.decode(jnp.asarray(anchors), jnp.asarray(preds[i]),
                             max_shape=tuple(SHAPES[i]))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_center_region_assigner_matches_jax():
    """Assignment, labels and ``shadowed_mat`` exactly the JAX assigner's,
    image by image, on anchors of several sizes around gts that nest and
    overlap (a padded gt slot included) and with invalid anchors."""
    rng = np.random.RandomState(5)
    anchors = np.concatenate([_boxes(rng, 300, 4, 40), _boxes(rng, 100, 30,
                                                              120)])
    gt, gvalid, glabels = _ground_truth(rng)
    gt[1, 1] = [gt[1, 0, 0] + 2, gt[1, 0, 1] + 2, gt[1, 0, 2] - 2,
                gt[1, 0, 3] - 2]                   # nested in gt 0
    box_valid = rng.uniform(size=(B, len(anchors))) > 0.1
    kw = dict(pos_scale=0.2, neg_scale=0.6, min_pos_iof=0.01)
    got = CenterRegionAssigner(**kw).assign(
        torch.from_numpy(anchors), torch.from_numpy(gt),
        torch.from_numpy(gvalid), torch.from_numpy(glabels),
        box_valid=torch.from_numpy(box_valid))
    theirs = jax.jit(lambda *a: JCenterRegionAssigner(**kw).assign(
        *a[:4], box_valid=a[4]), compiler_options=FAST_COMPILE)
    for i in range(B):
        want = theirs(*(jnp.asarray(x) for x in (
            anchors, gt[i], gvalid[i], glabels[i], box_valid[i])))
        for k in ('assigned_gt_inds', 'labels', 'shadowed_mat'):
            np.testing.assert_array_equal(got[k][i].numpy(),
                                          np.asarray(want[k]), err_msg=k)
    assert (got['assigned_gt_inds'] > 0).sum() > 5
    assert got['shadowed_mat'].sum() > 5


# --------------------------------------------------------------------------
# the FSAF head's loss: targets, level choice, gt_assign_hist
# --------------------------------------------------------------------------

LEVELS = [(16, 20), (8, 10), (4, 5), (2, 3), (1, 2)]


@pytest.fixture(scope='module')
def fsaf_head():
    """A small FSAF head (8 classes, 16 channels) on both sides, the JAX
    loss and its gradient compiled once, and random head outputs over 128 x
    160 images."""
    cfg = Config.fromfile(FSAF_CFG).todict()
    head = dict(cfg['model']['bbox_head'], num_classes=8, in_channels=16,
                feat_channels=16, stacked_convs=1)
    head.update(train_cfg=cfg['train_cfg'], test_cfg=cfg['test_cfg'])
    ours, theirs = build_head(head), j_build_head(head)
    rng = np.random.RandomState(6)
    cls = [rng.randn(B, h, w, 8).astype(np.float32) for h, w in LEVELS]
    box = [np.abs(rng.randn(B, h, w, 4)).astype(np.float32) * 0.4
           for h, w in LEVELS]
    gt, gvalid, glabels = _ground_truth(rng)
    glabels %= 8

    def loss(c, b, gv):
        out = theirs.loss(c, b, jnp.asarray(gt), gv, jnp.asarray(glabels),
                          jnp.asarray(SHAPES))
        return sum(v for k, v in out.items() if 'loss' in k), out
    # the logs and the gradient of the losses' sum
    jboth = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True),
                    compiler_options=FAST_COMPILE)

    def jax_run(gv):
        (_, logs), grads = jboth([jnp.asarray(x) for x in cls],
                                 [jnp.asarray(x) for x in box],
                                 jnp.asarray(gv))
        return logs, grads

    def port(gv, grad=False):
        tc = [torch.from_numpy(x.transpose(0, 3, 1, 2)).requires_grad_(grad)
              for x in cls]
        tb = [torch.from_numpy(x.transpose(0, 3, 1, 2)).requires_grad_(grad)
              for x in box]
        out = ours.loss(tc, tb, torch.from_numpy(gt), torch.from_numpy(gv),
                        torch.from_numpy(glabels), torch.from_numpy(SHAPES))
        return out, tc, tb
    return dict(jloss=lambda gv: jax_run(gv)[0], jgrad=lambda gv: jax_run(
        gv)[1], port=port, gvalid=gvalid, ours=ours)


@pytest.mark.parametrize('name', ['loss_cls', 'loss_bbox', 'num_pos',
                                  'accuracy', 'gt_assign_hist'])
def test_fsaf_loss_matches_jax(fsaf_head, name):
    """Each of the head's outputs within rtol 1e-4 (``gt_assign_hist`` and
    ``num_pos`` exactly)."""
    got = fsaf_head['port'](fsaf_head['gvalid'])[0]
    want = fsaf_head['jloss'](fsaf_head['gvalid'])
    assert sorted(got) == sorted(want)
    if name in ('gt_assign_hist', 'num_pos'):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
    else:
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   np.asarray(want[name]), rtol=1e-4,
                                   err_msg=name)
    assert float(got['num_pos']) > 0


def test_fsaf_level_choice_matches_jax(fsaf_head):
    """Each gt alone (the others' slots marked invalid): the level it
    chooses, read off ``gt_assign_hist``, is the JAX head's; over the gts
    the choices use more than one level."""
    levels = []
    gvalid = fsaf_head['gvalid']
    for i, j in zip(*np.nonzero(gvalid)):
        alone = np.zeros_like(gvalid)
        alone[i, j] = True
        got = fsaf_head['port'](alone)[0]['gt_assign_hist'].numpy()
        want = np.asarray(fsaf_head['jloss'](alone)['gt_assign_hist'])
        np.testing.assert_array_equal(got, want)
        assert got.sum() == 1
        levels.append(int(got.argmax()))
    assert len(set(levels)) > 1, levels


def test_fsaf_loss_gradients_match_jax(fsaf_head):
    """The gradient of ``loss_cls + loss_bbox`` with respect to every
    level's outputs within 1e-4 + 1e-3 of the largest: positives only at
    their gt's level, a dropped positive without its own class channel."""
    out, tc, tb = fsaf_head['port'](fsaf_head['gvalid'], grad=True)
    (out['loss_cls'] + out['loss_bbox']).backward()
    jc, jb = fsaf_head['jgrad'](fsaf_head['gvalid'])
    for got, want in zip(tc + tb, list(jc) + list(jb)):
        want = np.asarray(want).transpose(0, 3, 1, 2)
        tol = 1e-4 + 1e-3 * np.abs(want).max()
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=0, atol=tol)


def test_reg_decoded_bbox_loss_matches_jax():
    """``AnchorHead`` with ``reg_decoded_bbox`` (a RetinaHead with FSAF's
    TBLR coder and IoU loss, max-IoU assignment): its targets are the gt
    boxes, its box loss takes the decoded predictions; both losses within
    rtol 1e-4 of the JAX head's."""
    cfg = Config.fromfile(FSAF_CFG).todict()['model']['bbox_head']
    head = dict(cfg, type='RetinaHead', num_classes=8, in_channels=16,
                feat_channels=16, stacked_convs=1, anchor_generator=None,
                loss_cls=dict(type='FocalLoss', use_sigmoid=True),
                loss_bbox=dict(type='IoULoss', loss_weight=1.0),
                train_cfg=dict(assigner=dict(
                    type='MaxIoUAssigner', pos_iou_thr=0.5, neg_iou_thr=0.4,
                    min_pos_iou=0), allowed_border=-1, pos_weight=-1))
    ours, theirs = build_head(head), j_build_head(head)
    assert ours.reg_decoded_bbox and theirs.reg_decoded_bbox
    rng = np.random.RandomState(7)
    cls = [rng.randn(B, h, w, 9 * 8).astype(np.float32) for h, w in LEVELS]
    box = [np.abs(rng.randn(B, h, w, 9 * 4)).astype(np.float32) * 0.3
           for h, w in LEVELS]
    gt, gvalid, glabels = _ground_truth(rng)
    glabels %= 8
    got = ours.loss([torch.from_numpy(x.transpose(0, 3, 1, 2)) for x in cls],
                    [torch.from_numpy(x.transpose(0, 3, 1, 2)) for x in box],
                    *(torch.from_numpy(a) for a in (gt, gvalid, glabels,
                                                    SHAPES)), None)
    want = jax.jit(lambda c, b: theirs.loss(
        c, b, *(jnp.asarray(a) for a in (gt, gvalid, glabels, SHAPES)),
        jax.random.PRNGKey(0)), compiler_options=FAST_COMPILE)(
            [jnp.asarray(x) for x in cls], [jnp.asarray(x) for x in box])
    for k in ('loss_cls', 'loss_bbox'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, err_msg=k)
    anchors = torch.from_numpy(_boxes(rng, 500, 10, 80))
    targets = ours._targets(None, anchors, torch.ones(500, dtype=torch.bool),
                            *(torch.from_numpy(a) for a in (gt, gvalid,
                                                            glabels, SHAPES)))
    pos = targets[3][..., 0] > 0
    assert pos.any()
    for i in range(B):
        hits = (targets[2][i][pos[i]][:, None] == torch.from_numpy(gt[i]))
        assert hits.all(-1).any(-1).all()


# --------------------------------------------------------------------------
# the tiny FSAF detector, served and trained
# --------------------------------------------------------------------------

def tiny_fsaf(cfg):
    """R18, a 64-channel FPN from stride 8 with its two extra convs, and a
    64-channel head of two stacked convs per branch."""
    mc = cfg['model']
    mc.pop('pretrained', None)
    mc['backbone'].update(depth=18, stem_space_to_depth=True)
    mc['neck'][0].update(in_channels=[64, 128, 256, 512], out_channels=64)
    mc['bbox_head'].update(in_channels=64, feat_channels=64,
                           stacked_convs=2)
    return cfg


def _bn_stats(params, rng):
    """Non-trivial BatchNorm statistics and scales."""
    def walk(d, path):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif k == 'running_mean':
                d[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
            elif k == 'running_var':
                d[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == 'weight' and path[-1].startswith('bn'):
                d[k] = rng.normal(1, 0.1, v.shape).astype(np.float32)
    walk(params, ())
    return params


@pytest.fixture(scope='module')
def run():
    """The tiny FSAF detector on both sides: detections of two 128x160
    images (rescaled), and one ``forward_train`` + gradient, in one JAX
    program."""
    rng = np.random.RandomState(0)
    cfg = tiny_fsaf(Config.fromfile(FSAF_CFG).todict())
    tm = build_detector(cfg['model'], train_cfg=cfg['train_cfg'],
                        test_cfg=cfg['test_cfg'])
    init_weights(tm, torch.Generator().manual_seed(1))
    params = _bn_stats(state_dict_to_params(tm.state_dict()), rng)
    # the classifier spread so that scores pass the 0.05 threshold
    params['bbox_head']['retina_cls']['weight'] *= 26
    img = (rng.randn(B, H, W, 3) * 0.2).astype(np.float32)
    gt, gvalid, glabels = _ground_truth(rng)
    tm.load_state_dict(params_to_state_dict(params), strict=True)
    tm.eval()

    jcfg = tiny_fsaf(JConfig.fromfile(FSAF_CFG).todict())
    jm = j_build_detector(jcfg['model'], train_cfg=jcfg['train_cfg'],
                          test_cfg=jcfg['test_cfg'])
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jargs = [jnp.asarray(a) for a in (img, SHAPES, gt, gvalid, glabels)]

    def served_and_trained(p):
        dets = jm.simple_test(p, jargs[0], jargs[1], jnp.asarray(det.SCALES),
                              rescale=True)
        return dets, jax.value_and_grad(
            lambda q: j_parse_losses(jm.forward_train(
                q, *jargs, jax.random.PRNGKey(0))), has_aux=True)(p)
    jdets, ((_, jlogs), jgrads) = jax.jit(
        served_and_trained, compiler_options=FAST_COMPILE)(jp)

    tdets = tm.simple_test(*(torch.from_numpy(a) for a in
                             (img, SHAPES, det.SCALES)), rescale=True)
    tm.train()
    total, tlogs = parse_losses(tm.forward_train(
        *[torch.from_numpy(a) for a in (img, SHAPES, gt, gvalid, glabels)],
        torch.Generator().manual_seed(0)))
    total.backward()
    return dict(
        tm=tm, jax=dict(dets=[np.asarray(x) for x in jdets]),
        torch=dict(dets=[np.asarray(x) for x in tdets]),
        jlogs={k: np.asarray(v) for k, v in jlogs.items()},
        tlogs={k: v.detach().numpy() for k, v in tlogs.items()},
        jgrads=params_to_state_dict(jax.tree_util.tree_map(np.array,
                                                           jgrads)))


def test_tiny_fsaf_builds(run):
    """One square anchor a position over five levels, the TBLR coder, the
    center-region assigner, ``retina_reg``'s bias 0.25."""
    tm = run['tm']
    head = tm.bbox_head
    assert type(tm).__name__ == 'FSAF' and type(head).__name__ == 'FSAFHead'
    assert head.num_anchors == 1 and not head.sampling
    assert type(head.bbox_coder).__name__ == 'TBLRBBoxCoder'
    assert type(head.assigner).__name__ == 'CenterRegionAssigner'
    init_weights(head, torch.Generator().manual_seed(0))
    assert torch.all(head.retina_reg.bias == 0.25)


def test_tiny_fsaf_detections_match_jax(run):
    detections_match(run['jax'], run['torch'])
    assert run['torch']['dets'][2].sum() > 0


FSAF_LOGS = ['loss_cls', 'loss_bbox', 'num_pos', 'accuracy',
             'gt_assign_hist', 'loss']


@pytest.mark.parametrize('name', FSAF_LOGS)
def test_tiny_fsaf_losses_match_jax(run, name):
    """Each logged value within rtol 1e-4; the positives' count and the
    level histogram exactly (not losses: the total leaves them out)."""
    assert sorted(run['tlogs']) == sorted(run['jlogs']) == sorted(FSAF_LOGS)
    got, want = run['tlogs'][name], run['jlogs'][name]
    if name in ('num_pos', 'gt_assign_hist'):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=name)
    assert run['tlogs']['gt_assign_hist'].sum() == 9   # the valid gts


def test_tiny_fsaf_gradients_match_jax(run):
    """Every trainable parameter's gradient within 1e-4 + 1e-3 max|g|; the
    box branch has one."""
    bad, checked = [], 0
    params = dict(run['tm'].named_parameters())
    for name, p in params.items():
        if not p.requires_grad:
            continue
        want, got = run['jgrads'][name].numpy(), p.grad.numpy()
        tol = 1e-4 + 1e-3 * np.abs(want).max()
        err = np.abs(got - want).max()
        if not err <= tol:
            bad.append((name, float(err), float(tol)))
        checked += 1
    assert checked > 60 and not bad, bad[:5]
    for k in ('bbox_head.retina_reg.weight', 'bbox_head.reg_convs.0.conv.'
              'weight', 'bbox_head.retina_cls.weight'):
        assert float(params[k].grad.abs().max()) > 0, k


def test_train_loop_writes_gt_assign(tmp_path):
    """``train_detector`` on the tiny FSAF detector (one epoch of two bs2
    iterations over 4 box PNGs at 128 x 160, the log every iteration):
    ``gt_assign.txt`` holds the running count of the gts each level took,
    which over the epoch is every gt of the set once, and the histogram is
    not logged as a loss."""
    from arfe_tpu_torch.apis import train_detector
    from arfe_tpu_torch.data import build_dataset, synthetic
    from arfe_tpu_torch.tools import e2e_smoke
    root = str(tmp_path)
    _, anns = synthetic.write_box_set(root, [(128, 160)] * 4, seed=2)
    with open(os.path.join(root, 'base.py'), 'w') as f:
        f.write(e2e_smoke.CFG_TMPL.replace('{root}', root).replace(
            '{epochs}', '1'))
    base = Config.fromfile(os.path.join(root, 'base.py')).todict()
    cfg = tiny_fsaf(Config.fromfile(FSAF_CFG).todict())
    base['data']['train'].pop('classes')
    cfg.update(data=base['data'], total_epochs=1, work_dir=root, seed=0,
               log_config=dict(interval=1, hooks=[]),
               checkpoint_config=dict(interval=2),
               lr_config=dict(policy='step', step=[8]),
               optimizer=dict(type='SGD', lr=1e-3, momentum=0.9,
                              weight_decay=1e-4))
    model = build_detector(cfg['model'], train_cfg=cfg['train_cfg'],
                           test_cfg=cfg['test_cfg'])
    cfg = Config(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    history = train_detector(model, build_dataset(cfg.todict()['data'][
        'train']), cfg, device='cpu')
    train = [e for e in history if e['mode'] == 'train']
    assert len(train) == 2 and 'gt_assign_hist' not in train[0]
    assert all(np.isfinite(e['loss']) for e in train)
    with open(os.path.join(root, 'gt_assign.txt')) as f:
        counts = [int(c) for c in f.read().split()]
    assert len(counts) == 5 and sum(counts) == len(anns)
