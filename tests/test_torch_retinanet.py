"""RetinaNet + AR-FPN (config #2) in the port against the JAX package on the
CPU: the FPN's extra levels in every mode, the pseudo sampler, the sigmoid
focal loss with background rows, the dense head's detections
(``AnchorHead.get_bboxes``: per-level top-k, decode, rescale, multi-class
NMS) and its targets and losses without sampling, the tiny detector served
and trained, and the ``bbox`` evaluation through the ``test`` CLI on
synthetic PNGs.

Both sides start from the port's seeded weights, converted. RetinaNet
samples nothing, so no priorities are shared.
"""
import contextlib
import io
import os
from functools import partial
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_detector as det
import torch
from test_torch_arrff import FAST_COMPILE
from test_torch_cascade import (SEED, SIZES, STATS, TEST_SCALE, _serve_jax,
                                detections_match, perturb, reused_program,
                                tiny_trunk)
from test_torch_eval import _write_config
from test_torch_train import B, H, SHAPES, W, _ground_truth

from arfe_tpu.apis.test import single_device_test as j_single_device_test
from arfe_tpu.config import Config as JConfig
from arfe_tpu.convert import state_dict_to_params
from arfe_tpu.core.bbox import samplers as jsamplers
from arfe_tpu.data import build_dataloader as j_build_dataloader
from arfe_tpu.data import build_dataset as j_build_dataset
from arfe_tpu.models import build_detector as j_build_detector
from arfe_tpu.models.builder import build_head as j_build_head
from arfe_tpu.models.builder import build_neck as j_build_neck
from arfe_tpu.models.losses import focal_loss as jfocal
from arfe_tpu.train import parse_losses as j_parse_losses
from arfe_tpu_torch.apis import init_detector
from arfe_tpu_torch.config import Config
from arfe_tpu_torch.convert import params_to_state_dict
from arfe_tpu_torch.core.bbox import PseudoSampler
from arfe_tpu_torch.data import synthetic
from arfe_tpu_torch.layers import init_weights
from arfe_tpu_torch.models import build_detector
from arfe_tpu_torch.models.builder import build_head, build_neck
from arfe_tpu_torch.models.losses import py_sigmoid_focal_loss
from arfe_tpu_torch.tools import test as test_cli
from arfe_tpu_torch.train import parse_losses
from arfe_tpu_torch.utils import save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RETINA_CFG = os.path.join(REPO, 'configs', 'arfe',
                          'retinanet_r50_arfpn_1x_coco.py')
PORT_CFG = os.path.join(REPO, 'arfe_tpu_torch', 'configs',
                        'retinanet_r50_arfpn_1x_coco.py')
# the tiny head's classifier weights scaled by this (its bias, the prior,
# kept): at the drawn std 0.01 every score sits at the prior 0.01, under the
# 0.05 threshold; at 26 the two images keep 37 and 45 detections, the top
# score 0.09
CLS_SPREAD = 26.0


def tiny_retina(cfg):
    """The tiny trunk (R18, 64-channel FPN from stride 8 with its two extra
    convs on C5, AR-FPN over five levels) and a 64-channel head of two
    stacked convs per branch."""
    cfg = tiny_trunk(cfg)
    cfg['model']['bbox_head'].update(in_channels=64, feat_channels=64,
                                     stacked_convs=2)
    return cfg


def _head_cfg(num_classes=8):
    head = dict(Config.fromfile(RETINA_CFG).todict()['model']['bbox_head'],
                num_classes=num_classes, in_channels=16, feat_channels=16,
                stacked_convs=1)
    cfg = Config.fromfile(RETINA_CFG).todict()
    return dict(head, train_cfg=cfg['train_cfg'], test_cfg=dict(
        cfg['test_cfg'], nms_pre=10))


# --------------------------------------------------------------------------
# the FPN's extra levels
# --------------------------------------------------------------------------

FPN_MODES = {
    'max_pool': dict(num_outs=5),
    'true_on_input': dict(start_level=1, add_extra_convs=True, num_outs=5),
    'true_on_output': dict(start_level=1, add_extra_convs=True,
                           extra_convs_on_inputs=False, num_outs=5),
    'on_input': dict(start_level=1, add_extra_convs='on_input', num_outs=5),
    'on_lateral_relu': dict(start_level=1, add_extra_convs='on_lateral',
                            relu_before_extra_convs=True, num_outs=6),
    'on_output_relu': dict(add_extra_convs='on_output',
                           relu_before_extra_convs=True, num_outs=6),
    'end_level': dict(start_level=1, end_level=3, num_outs=2),
}


@pytest.mark.parametrize('mode', FPN_MODES)
def test_fpn_extra_levels_match_jax(mode):
    """The FPN of each ``add_extra_convs`` mode within 1e-5 of the JAX
    package's, with the same parameter names: the extra convs continue the
    ``fpn_convs`` index; a 13 x 21 level upsampled to 25 x 42 (nearest, at
    a ratio that is not an integer)."""
    cfg = dict(type='FPN', in_channels=[8, 16, 24, 32], out_channels=16,
               **FPN_MODES[mode])
    ours, theirs = build_neck(cfg), j_build_neck(cfg)
    init_weights(ours, torch.Generator().manual_seed(0))
    params = state_dict_to_params(ours.state_dict())
    rng = np.random.RandomState(1)
    sizes = [(100, 168), (50, 84), (25, 42), (13, 21)]
    inputs = [rng.randn(2, c, h, w).astype(np.float32)
              for c, (h, w) in zip(cfg['in_channels'], sizes)]
    got = ours([torch.from_numpy(x) for x in inputs])
    want = jax.jit(theirs.__call__, compiler_options=FAST_COMPILE)(
        jax.tree_util.tree_map(jnp.asarray, params),
        [jnp.asarray(x.transpose(0, 2, 3, 1)) for x in inputs])
    assert len(got) == len(want) == cfg['num_outs']
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy().transpose(0, 2, 3, 1),
                                   np.asarray(w), rtol=1e-5, atol=1e-5)
    extra = cfg['num_outs'] - len(ours.lateral_convs)
    assert len(ours.fpn_convs) == len(ours.lateral_convs) + (
        extra if cfg.get('add_extra_convs') else 0)


# --------------------------------------------------------------------------
# pseudo sampler, focal loss
# --------------------------------------------------------------------------

def test_pseudo_sampler_matches_jax():
    """Every candidate in its own slot: positives assigned > 0, valid slots
    assigned >= 0, image by image as the JAX sampler."""
    assigned = np.random.RandomState(2).randint(-1, 4, (B, 300))
    got = PseudoSampler().sample(torch.Generator(),
                                 torch.from_numpy(assigned))
    for i in range(B):
        want = jsamplers.PseudoSampler().sample(jax.random.PRNGKey(0),
                                                jnp.asarray(assigned[i]))
        for k in ('inds', 'is_pos', 'valid'):
            np.testing.assert_array_equal(got[k][i].numpy(),
                                          np.asarray(want[k]))


@pytest.mark.parametrize('weighted', [True, False])
@pytest.mark.parametrize('reduction,avg', [('mean', None), ('mean', 37.0),
                                           ('sum', None), ('none', None)])
def test_focal_loss_matches_jax(weighted, reduction, avg):
    """The sigmoid focal loss of int labels, the background label C among
    them (an all-zero target row), and of one-hot targets, within 1e-6
    relative; weighted per row."""
    rng = np.random.RandomState(3)
    n, c = 200, 7
    pred = (rng.randn(n, c) * 4).astype(np.float32)
    labels = rng.randint(0, c + 1, n)
    labels[:20] = c
    weight = rng.uniform(0, 2, n).astype(np.float32) if weighted else None
    onehot = np.eye(c + 1, dtype=np.float32)[labels][:, :c]
    for target in (labels, onehot):
        got = py_sigmoid_focal_loss(
            torch.from_numpy(pred), torch.from_numpy(target),
            None if weight is None else torch.from_numpy(weight),
            reduction=reduction, avg_factor=avg).numpy()
        want = jfocal.py_sigmoid_focal_loss(
            jnp.asarray(pred), jnp.asarray(target),
            None if weight is None else jnp.asarray(weight),
            reduction=reduction, avg_factor=avg)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                   atol=1e-7)


# --------------------------------------------------------------------------
# the dense head: detections, targets and losses
# --------------------------------------------------------------------------

LEVELS = [(H // s, W // s) for s in (8, 16, 32)] + [(2, 3), (1, 2)]


def _head_outputs(rng, num_classes=8, num_anchors=9):
    """Per-level (B, A * C, h, w) logits, of which ~2% of the finest
    level's anchors score above 0.05, and (B, A * 4, h, w) regressions, for
    a 128x160 image."""
    cls = [(rng.randn(B, num_anchors * num_classes, h, w) * 1.3 - 6.5)
           .astype(np.float32) for h, w in LEVELS]
    reg = [(rng.randn(B, num_anchors * 4, h, w) * 0.3).astype(np.float32)
           for h, w in LEVELS]
    return cls, reg


def _nhwc(xs):
    return [jnp.asarray(x.transpose(0, 2, 3, 1)) for x in xs]


@pytest.mark.parametrize('rescale', [True, False])
def test_get_bboxes_matches_jax(rescale):
    """Per level the 10 candidates of largest score (of 2880 to 18; the
    finest level holds ~70 above the score threshold), decoded, clamped,
    rescaled or not, through multi-class NMS: the same valid slots and
    labels, boxes and scores within 1e-4 relative plus 1e-3 absolute."""
    cfg = _head_cfg()
    ours, theirs = build_head(cfg), j_build_head(cfg)
    cls, reg = _head_outputs(np.random.RandomState(4))
    got = ours.get_bboxes([torch.from_numpy(x) for x in cls],
                          [torch.from_numpy(x) for x in reg],
                          torch.from_numpy(SHAPES),
                          torch.from_numpy(det.SCALES), rescale=rescale)
    want = jax.jit(partial(theirs.get_bboxes, rescale=rescale),
                   compiler_options=FAST_COMPILE)(
        _nhwc(cls), _nhwc(reg), jnp.asarray(SHAPES),
        jnp.asarray(det.SCALES))
    (td, tl_, tv), (jd, jl, jv) = [[np.asarray(x) for x in o]
                                   for o in (got, want)]
    assert 20 <= jv.sum(1).min() and jv.sum(1).max() < 100
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tl_, jl)
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-3)


@pytest.fixture(scope='module')
def targets():
    """Both heads' anchor targets and losses without sampling on random
    outputs of a 128x160 image pair, the gts of ``test_torch_train``."""
    cfg = _head_cfg()
    ours, theirs = build_head(cfg), j_build_head(cfg)
    rng = np.random.RandomState(5)
    cls, reg = _head_outputs(rng)
    gt, gvalid, glabels = _ground_truth(rng)
    glabels = glabels % 8
    anchors, flags = ours._flat_anchor_table(LEVELS, 'cpu')
    tout = ours._targets(torch.Generator(), anchors, flags,
                         *(torch.from_numpy(a) for a in (gt, gvalid, glabels,
                                                         SHAPES)))
    janchors, jflags = theirs._flat_anchor_table(LEVELS)

    def jtargets(g, v, lab, shape):
        return theirs._targets_single(jax.random.PRNGKey(0), janchors,
                                      jflags, g, v, lab, shape)[:6]

    def jax_side(c, r, *a):
        return jax.vmap(jtargets)(*a), theirs.loss(c, r, *a,
                                                   jax.random.PRNGKey(0))

    jout, jloss = jax.jit(jax_side, compiler_options=FAST_COMPILE)(
        _nhwc(cls), _nhwc(reg), *(jnp.asarray(a) for a in (
            gt, gvalid, glabels, SHAPES)))
    tloss = ours.loss([torch.from_numpy(x) for x in cls],
                      [torch.from_numpy(x) for x in reg],
                      *(torch.from_numpy(a) for a in (gt, gvalid, glabels,
                                                      SHAPES)),
                      torch.Generator())
    return dict(anchors=(anchors.numpy(), np.asarray(janchors)),
                tout=[t.numpy() for t in tout],
                jout=[np.asarray(t) for t in jout],
                tloss={k: float(v) for k, v in tloss.items()},
                jloss={k: float(v) for k, v in jloss.items()})


TARGETS = ['labels', 'label_weights', 'bbox_targets', 'bbox_weights',
           'num_pos', 'num_neg']


@pytest.mark.parametrize('name', TARGETS)
def test_unsampled_targets_match_jax(targets, name):
    """Without sampling every anchor is a target: positives (IoU >= 0.5)
    with their gt's label and box deltas, negatives (< 0.4) weighted 1 and
    labelled background, the rest 0; anchors in (position, anchor) order,
    the JAX package's."""
    np.testing.assert_array_equal(*targets['anchors'])
    i = TARGETS.index(name)
    got, want = targets['tout'][i], targets['jout'][i]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if name == 'num_pos':
        assert (got > 0).all() and (targets['tout'][5] > got).all()


@pytest.mark.parametrize('name', ['loss_cls', 'loss_bbox'])
def test_unsampled_losses_match_jax(targets, name):
    """The focal and L1 losses averaged over the positives only."""
    assert sorted(targets['tloss']) == ['loss_bbox', 'loss_cls']
    np.testing.assert_allclose(targets['tloss'][name],
                               targets['jloss'][name], rtol=1e-5)
    assert targets['tloss'][name] > 0


# --------------------------------------------------------------------------
# the tiny detector, served and trained
# --------------------------------------------------------------------------

@pytest.fixture(scope='module')
def run():
    """The tiny RetinaNet on both sides: detections of two 128x160 images
    with and without ``rescale``, and one ``forward_train`` + gradient."""
    rng = np.random.RandomState(0)
    cfg = tiny_retina(Config.fromfile(RETINA_CFG).todict())
    model = init_detector(Config(cfg), device='cpu')
    init_weights(model, torch.Generator().manual_seed(SEED))
    params = perturb(state_dict_to_params(model.state_dict()), rng,
                     [(('bbox_head', 'retina_cls'), CLS_SPREAD)])
    img = (rng.randn(B, H, W, 3) * 0.2).astype(np.float32)
    gt, gvalid, glabels = _ground_truth(rng)

    tm = build_detector(cfg['model'], train_cfg=cfg['train_cfg'],
                        test_cfg=cfg['test_cfg'])
    tm.load_state_dict(params_to_state_dict(params), strict=True)
    tm.eval()
    jcfg = tiny_retina(JConfig.fromfile(RETINA_CFG).todict())
    jm = j_build_detector(jcfg['model'], train_cfg=jcfg['train_cfg'],
                          test_cfg=jcfg['test_cfg'])
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jargs = [jnp.asarray(a) for a in (img, SHAPES, gt, gvalid, glabels)]

    jserve, jdets = _serve_jax(jm, jp, jargs[0], jargs[1])
    (_, jlogs), jgrads = jax.jit(jax.value_and_grad(
        lambda q: j_parse_losses(jm.forward_train(
            q, *jargs, jax.random.PRNGKey(0))), has_aux=True),
        compiler_options=FAST_COMPILE)(jp)

    timg, tshapes, tscales = (torch.from_numpy(a) for a in
                              (img, SHAPES, det.SCALES))
    tdets = [tm.simple_test(timg, tshapes, tscales, rescale=rescale)
             for rescale in (True, False)]
    tm.train()
    total, tlogs = parse_losses(tm.forward_train(
        *[torch.from_numpy(a) for a in (img, SHAPES, gt, gvalid, glabels)],
        torch.Generator().manual_seed(0)))
    total.backward()
    to_np = lambda xs: [np.asarray(x) for x in xs]  # noqa: E731
    return dict(
        tm=tm, jm=jm, params=params, jserve=jserve,
        jax=[dict(dets=to_np(d)) for d in jdets],
        torch=[dict(dets=to_np(d)) for d in tdets],
        jlogs={k: float(v) for k, v in jlogs.items()},
        tlogs={k: float(v.detach()) for k, v in tlogs.items()},
        jgrads=params_to_state_dict(jax.tree_util.tree_map(np.array,
                                                           jgrads)))


def test_tiny_retinanet_builds(run):
    """Five levels from stride 8, the extra convs on C5 then P6; the
    state_dict names are the reference's."""
    tm = run['tm']
    assert type(tm).__name__ == 'RetinaNet' and not tm.bbox_head.sampling
    assert type(tm.bbox_head.sampler).__name__ == 'PseudoSampler'
    names = tm.state_dict()
    for k in ('neck.0.fpn_convs.3.conv.weight', 'neck.0.fpn_convs.4.conv.'
              'weight', 'bbox_head.cls_convs.1.conv.weight',
              'bbox_head.reg_convs.1.conv.weight', 'bbox_head.retina_cls.'
              'bias', 'bbox_head.retina_reg.weight'):
        assert k in names, k
    assert names['neck.0.fpn_convs.3.conv.weight'].shape[1] == 512
    with torch.no_grad():
        sizes = [tuple(f.shape[2:]) for f in tm.extract_feat(
            torch.zeros(1, H, W, 3))]
    assert sizes == LEVELS


@pytest.mark.parametrize('rescale', [True, False])
def test_tiny_retinanet_detections_match_jax(run, rescale):
    """``test_torch_cascade.detections_match``: the matching rule, then
    slot by slot within 1e-4 relative plus 1e-3 absolute."""
    i = 0 if rescale else 1
    detections_match(run['jax'][i], run['torch'][i])
    assert run['torch'][i]['dets'][2].sum(1).max() < 100


@pytest.mark.parametrize('name', ['loss_cls', 'loss_bbox', 'loss'])
def test_tiny_retinanet_losses_match_jax(run, name):
    assert sorted(run['tlogs']) == sorted(run['jlogs']) == [
        'loss', 'loss_bbox', 'loss_cls']
    assert np.isfinite(run['tlogs'][name]) and run['tlogs'][name] > 0
    np.testing.assert_allclose(run['tlogs'][name], run['jlogs'][name],
                               rtol=1e-4, err_msg=name)


def test_tiny_retinanet_gradients_match_jax(run):
    """Every trainable parameter's gradient within 1e-4 + 1e-3 max|g|; the
    extra convs and both towers have one."""
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
    assert checked > 80 and not bad, bad[:5]
    for k in ('neck.0.fpn_convs.4.conv.weight', 'bbox_head.cls_convs.0.conv.'
              'weight', 'bbox_head.reg_convs.0.conv.weight'):
        assert float(params[k].grad.abs().max()) > 0, k


# --------------------------------------------------------------------------
# evaluation: bbox through the test CLI
# --------------------------------------------------------------------------

def _data_cfg(root):
    pipeline = Config.fromfile(PORT_CFG).todict()['data']['test']['pipeline']
    pipeline[1]['img_scale'] = TEST_SCALE
    return dict(type='CocoDataset', ann_file=os.path.join(root, 'ann.json'),
                img_prefix=os.path.join(root, 'imgs'), pipeline=pipeline)


@pytest.fixture(scope='module')
def stack(run, tmp_path_factory):
    """``test_torch_cascade.stack`` for the tiny RetinaNet."""
    root = str(tmp_path_factory.mktemp('retina'))
    images = synthetic.write_images(root, SIZES, seed=12)
    synthetic.write_annotations(os.path.join(root, 'ann.json'), images)
    jloader = j_build_dataloader(
        j_build_dataset(_data_cfg(root), dict(test_mode=True)),
        samples_per_gpu=B, workers_per_gpu=0, shuffle=False,
        static_shapes=None, test_mode=True)
    with mock.patch.object(jax, 'jit', reused_program(run)):
        jresults = j_single_device_test(
            run['jm'], jax.tree_util.tree_map(jnp.asarray, run['params']),
            jloader, show_progress=False)
    synthetic.write_annotations(
        os.path.join(root, 'ann.json'), images,
        synthetic.seed_ground_truth(images, jresults))
    jstats = j_build_dataset(_data_cfg(root), dict(test_mode=True)) \
        .evaluate(jresults, metric='bbox')

    cfg = tiny_retina(Config.fromfile(PORT_CFG).todict())
    cfg['data'].update(test=_data_cfg(root), workers_per_gpu=0)
    config = os.path.join(root, 'cfg.py')
    _write_config(config, cfg)
    model = init_detector(Config(cfg), device='cpu')
    model.load_state_dict(params_to_state_dict(run['params']))
    ckpt = save_checkpoint(os.path.join(root, 'retina.pth'), model)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        stats = test_cli.main([config, ckpt, '--device', 'cpu', '--eval',
                               'bbox'])
    return dict(stats=stats, jstats=jstats, printed=printed.getvalue())


def test_retinanet_stats_match_jax(stack):
    """The six bbox stats of the CLI within 1e-6 of the JAX package's, the
    mAP inside (0.05, 0.999), and printed."""
    got, want = stack['stats'], stack['jstats']
    assert sorted(got) == sorted(want) == sorted(STATS)
    assert 0.05 < want['bbox_mAP'] < 0.999, want
    for k in STATS:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
        assert f'{k}: ' in stack['printed']
