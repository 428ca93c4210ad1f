"""Cascade R-CNN + AR-FPN (config #5b) in the port against the JAX package on
the CPU: the refinement decode with each stage's head and coder, the tiny
detector served and trained (three stages of assignment, sampling, losses
and refinement), the RoI head's default pseudo sampler, and the ``bbox``
evaluation through the ``test`` CLI (``single_device_test`` and the
dataset's ``evaluate``) on synthetic PNGs.

Both sides start from the port's seeded weights, converted; the samplers of
the RPN and of each stage get the same numpy priorities on both sides, and
the JAX instance's RoIs enter its extractors without gradient, as in
``test_torch_train.py``.
"""
import contextlib
import io
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_detector as det
import torch
from test_torch_arrff import FAST_COMPILE
from test_torch_eval import _write_config
from test_torch_train import (B, G, H, SHAPES, W, _ground_truth, _patch_jax,
                              _patch_torch, _proposals, _RoIsWithoutGradient)

from arfe_tpu.apis.test import single_device_test as j_single_device_test
from arfe_tpu.config import Config as JConfig
from arfe_tpu.convert import state_dict_to_params
from arfe_tpu.data import build_dataloader as j_build_dataloader
from arfe_tpu.data import build_dataset as j_build_dataset
from arfe_tpu.models import build_detector as j_build_detector
from arfe_tpu.models.builder import build_head as j_build_head
from arfe_tpu.train import parse_losses as j_parse_losses
from arfe_tpu_torch.apis import init_detector
from arfe_tpu_torch.config import Config
from arfe_tpu_torch.convert import params_to_state_dict
from arfe_tpu_torch.data import synthetic
from arfe_tpu_torch.layers import init_weights
from arfe_tpu_torch.models import build_detector
from arfe_tpu_torch.models.builder import build_head
from arfe_tpu_torch.tools import test as test_cli
from arfe_tpu_torch.train import parse_losses
from arfe_tpu_torch.train.bench import num_anchors
from arfe_tpu_torch.utils import save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASCADE_CFG = os.path.join(REPO, 'configs', 'arfe',
                           'cascade_rcnn_r50_arfpn_1x_coco.py')
PORT_CFG = os.path.join(REPO, 'arfe_tpu_torch', 'configs',
                        'cascade_rcnn_r50_arfpn_1x_coco.py')
STAGES = 3
NUM = 64                      # proposals and samples per image and stage
STDS = [(0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1),
        (0.033, 0.033, 0.067, 0.067)]
TEST_SCALE = (160, 128)
# (h, w): each resizes to at most 160 x 128 and pads to the served images'
# 128 x 160, so the JAX package's evaluation runs the program compiled for
# them
SIZES = [(240, 320), (225, 300), (230, 310), (192, 256)]
STATS = ['bbox_mAP', 'bbox_AP50', 'bbox_AP75', 'bbox_APs', 'bbox_APm',
         'bbox_APl']


def tiny_trunk(cfg):
    """The trunk of a config dict cut as ``__graft_entry__._build_flagship(
    tiny=True)`` cuts the flagship's: R18, 64-channel FPN and AR-FPN."""
    mc = cfg['model']
    mc.pop('pretrained', None)
    mc['backbone'].update(depth=18, stem_space_to_depth=True)
    mc['neck'][0].update(in_channels=[64, 128, 256, 512], out_channels=64)
    mc['neck'][1]['in_channels'] = 64
    return cfg


def tiny_cascade(cfg):
    """The tiny trunk, a 64-channel RPN, ``NUM`` proposals, and each stage's
    head at 64 channels and 128-wide FCs sampling ``NUM`` RoIs."""
    cfg = tiny_trunk(cfg)
    mc = cfg['model']
    mc['rpn_head'].update(in_channels=64, feat_channels=64)
    mc['roi_head']['bbox_roi_extractor']['out_channels'] = 64
    for head in mc['roi_head']['bbox_head']:
        head.update(in_channels=64, fc_out_channels=128)
    tc = cfg['train_cfg']
    tc['rpn']['sampler']['num'] = 64
    tc['rpn_proposal'].update(nms_pre=100, nms_post=NUM, max_num=NUM)
    for stage in tc['rcnn']:
        stage['sampler']['num'] = NUM
    cfg['test_cfg']['rpn'].update(nms_pre=100, nms_post=NUM, max_num=NUM)
    return cfg


# The weights' seed, as ``test_torch_mask.SEED``: at some seeds the tiny
# detector's f32 step is ill-conditioned (windows of the AR-FPN neck's
# adaptive max pools hold values within f32 rounding of each other, and
# which one is the maximum decides where the gradient goes), so the port's
# f32 backbone gradients differ from its own f64 ones by up to ~2% of their
# largest.
SEED = 3


def perturb(params, rng, classifiers=()):
    """``test_torch_detector._perturb``'s BN statistics and NonLocal
    ``conv_out``, and each classifier weight of ``classifiers`` (a path of
    keys and a factor) scaled so that the scores spread."""
    view = dict(params, rpn_head={'rpn_cls': {'weight': np.zeros(1)}},
                roi_head={'bbox_head': {'fc_cls': {'weight': np.zeros(1)}}})
    det._perturb(view, rng)
    for path, factor in classifiers:
        d = params
        for k in path:
            d = d[k]
        d['weight'] = d['weight'] * factor
    return params


def _port_params(cfg, rng):
    """The port's seeded weights as a JAX parameter tree, perturbed, the
    RPN's and each stage's classifier spread as the detector tests do (the
    stages' averaged logits spread less than one head's: at 60 the two
    images keep 63 and 71 detections, below the cut of 100)."""
    model = init_detector(Config(cfg), device='cpu')
    init_weights(model, torch.Generator().manual_seed(SEED))
    return perturb(state_dict_to_params(model.state_dict()), rng,
                   [(('rpn_head', 'rpn_cls'), 8)]
                   + [(('roi_head', 'bbox_head', str(i), 'fc_cls'), 60)
                      for i in range(STAGES)])


# --------------------------------------------------------------------------
# the refinement decode, with each stage's head and coder
# --------------------------------------------------------------------------

@pytest.mark.parametrize('stage', range(STAGES))
@pytest.mark.parametrize('agnostic', [True, False])
def test_refine_decode_matches_jax(stage, agnostic):
    """``decoded_boxes_for_refine`` of the config's stage-``stage`` head
    (its own ``target_stds``), class-agnostic or by the argmax foreground
    class, clamped to each image and not, within 1e-4 of the JAX head's,
    image by image."""
    cfg = Config.fromfile(CASCADE_CFG).todict()
    head_cfg = dict(cfg['model']['roi_head']['bbox_head'][stage],
                    reg_class_agnostic=agnostic, num_classes=6,
                    in_channels=8, fc_out_channels=16)
    ours, theirs = build_head(head_cfg), j_build_head(head_cfg)
    assert ours.bbox_coder.stds == STDS[stage]
    rng = np.random.RandomState(stage)
    xy = rng.uniform(0, 150, (B, 40, 2))
    rois = np.concatenate([xy, xy + rng.uniform(1, 90, (B, 40, 2))],
                          -1).astype(np.float32)
    cls_score = rng.randn(B, 40, 7).astype(np.float32)
    cls_score[0, :5, 6] = 9.0          # background largest: not a candidate
    bbox_pred = rng.randn(B, 40, 4 if agnostic else 24).astype(np.float32)
    for shapes in (SHAPES, None):
        got = ours.decoded_boxes_for_refine(
            *(torch.from_numpy(a) for a in (rois, cls_score, bbox_pred)),
            None if shapes is None else torch.from_numpy(shapes)).numpy()
        for i in range(B):
            want = theirs.decoded_boxes_for_refine(
                jnp.asarray(rois[i]), jnp.asarray(cls_score[i]),
                jnp.asarray(bbox_pred[i]),
                None if shapes is None else jnp.asarray(shapes[i]))
            np.testing.assert_allclose(got[i], np.asarray(want), rtol=1e-5,
                                       atol=1e-4)
        if shapes is not None:
            assert (got[..., 2] <= shapes[:, None, 1]).all()


# --------------------------------------------------------------------------
# the tiny detector, served and trained
# --------------------------------------------------------------------------

def _fix_stage_priorities(jm, tm, rng, n_anchors):
    """The same numpy priorities on both sides' RPN sampler and each
    stage's: stage 0 draws among G + NUM candidates (gts and proposals),
    later stages among G + the previous stage's NUM samples."""
    prio = [rng.uniform(size=n).astype(np.float32)
            for n in (n_anchors, n_anchors)]
    for m, patch in ((jm, _patch_jax), (tm, _patch_torch)):
        patch(m.rpn_head.sampler, *prio)
    for stage in range(STAGES):
        prio = [rng.uniform(size=G + NUM).astype(np.float32)
                for _ in range(2)]
        for m, patch in ((jm, _patch_jax), (tm, _patch_torch)):
            patch(m.roi_head.samplers[stage], *prio)


def _serve_jax(jm, params, img, shapes):
    """The JAX detector's ``simple_test(rescale=True)``, compiled once, and
    its detections of ``img`` rescaled by ``det.SCALES`` and by unit
    factors, which is ``rescale=False`` (a division by 1 is exact)."""
    serve = jax.jit(lambda p, im, sh, sf: jm.simple_test(p, im, sh, sf,
                                                         rescale=True),
                    compiler_options=FAST_COMPILE)
    return serve, [serve(params, img, shapes, jnp.asarray(sf)) for sf in
                   (det.SCALES, np.ones_like(det.SCALES))]


def reused_program(run):
    """A stand-in for ``jax.jit`` inside the JAX package's
    ``single_device_test``, whose program is ``simple_test(rescale=True)``:
    the run's compiled one, for batches of its shape."""
    return lambda fn, **kwargs: run['jserve']


@pytest.fixture(scope='module')
def run():
    """The tiny Cascade R-CNN on both sides: detections of two 128x160
    images with and without ``rescale``, and one ``forward_train`` +
    gradient with shared priorities."""
    rng = np.random.RandomState(0)
    cfg = tiny_cascade(Config.fromfile(CASCADE_CFG).todict())
    params = _port_params(cfg, rng)
    img = (rng.randn(B, H, W, 3) * 0.2).astype(np.float32)
    gt, gvalid, glabels = _ground_truth(rng)

    tm = build_detector(cfg['model'], train_cfg=cfg['train_cfg'],
                        test_cfg=cfg['test_cfg'])
    tm.load_state_dict(params_to_state_dict(params), strict=True)
    tm.eval()
    jcfg = tiny_cascade(JConfig.fromfile(CASCADE_CFG).todict())
    jm = j_build_detector(jcfg['model'], train_cfg=jcfg['train_cfg'],
                          test_cfg=jcfg['test_cfg'])
    _fix_stage_priorities(jm, tm, rng, num_anchors(tm, H, W))
    head = jm.roi_head
    head.bbox_roi_extractor = [_RoIsWithoutGradient(e)
                               for e in head.bbox_roi_extractor]

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


def test_tiny_cascade_builds(run):
    """Three stages, each its own head and coder and its own assigner's
    thresholds; the state_dict names are ``roi_head.bbox_head.{i}.…``."""
    head = run['tm'].roi_head
    assert type(run['tm']).__name__ == 'CascadeRCNN'
    assert type(head).__name__ == 'CascadeRoIHead' and not head.with_mask
    assert [h.bbox_coder.stds for h in head.bbox_head] == STDS
    assert [a.pos_iou_thr for a in head.assigners] == [0.5, 0.6, 0.7]
    assert head.stage_loss_weights == [1, 0.5, 0.25]
    names = run['tm'].state_dict()
    assert all(f'roi_head.bbox_head.{i}.fc_cls.weight' in names
               for i in range(STAGES))


def detections_match(want, got):
    """``test_torch_detector.test_detections_match_jax``'s rule, then slot
    by slot: the same validity and labels, boxes and scores within 1e-4
    relative plus 1e-3 absolute."""
    det.test_detections_match_jax(dict(jax=want, torch=got))
    (jd, jl, jv), (td, tl_, tv) = want['dets'], got['dets']
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tl_[tv], jl[jv])
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize('rescale', [True, False])
def test_tiny_cascade_detections_match_jax(run, rescale):
    i = 0 if rescale else 1
    detections_match(run['jax'][i], run['torch'][i])


LOSSES = ['loss_rpn_cls', 'loss_rpn_bbox'] + [
    f's{i}.{k}' for i in range(STAGES)
    for k in ('loss_cls', 'acc', 'loss_bbox')] + ['loss']


@pytest.mark.parametrize('name', LOSSES)
def test_tiny_cascade_losses_match_jax(run, name):
    """Each stage's losses with its own targets' coder, scaled by its
    weight, within rtol 1e-4."""
    assert sorted(run['tlogs']) == sorted(run['jlogs']) == sorted(LOSSES)
    assert np.isfinite(run['tlogs'][name])
    np.testing.assert_allclose(run['tlogs'][name], run['jlogs'][name],
                               rtol=1e-4, err_msg=name)


def test_tiny_cascade_gradients_match_jax(run):
    """Every trainable parameter's gradient within 1e-4 + 1e-3 max|g|;
    every stage's head has one."""
    bad, checked = [], 0
    for name, p in run['tm'].named_parameters():
        if not p.requires_grad:
            continue
        want, got = run['jgrads'][name].numpy(), p.grad.numpy()
        tol = 1e-4 + 1e-3 * np.abs(want).max()
        err = np.abs(got - want).max()
        if not err <= tol:
            bad.append((name, float(err), float(tol)))
        checked += 1
    assert checked > 100 and not bad, bad[:5]
    for i in range(STAGES):
        g = dict(run['tm'].named_parameters())[
            f'roi_head.bbox_head.{i}.fc_reg.weight'].grad
        assert float(g.abs().max()) > 0


# --------------------------------------------------------------------------
# the cascade head alone, on proposals around the gts
# --------------------------------------------------------------------------

def _recording(forward, log):
    """``_bbox_forward`` that also keeps each stage's RoIs."""
    def recorded(*args):
        log.append(args[-1])
        return forward(*args)
    return recorded


@pytest.fixture(scope='module')
def head_run():
    """The config's cascade head at 64 channels on both sides, on random
    features and proposals of which half lie within 6 px of a gt, its
    regressions spread (``fc_reg`` x 100) so each stage moves its boxes:
    every stage's sampled RoIs and losses, with shared priorities and the
    refined boxes clamped to the images."""
    rng = np.random.RandomState(1)
    cfg = tiny_cascade(Config.fromfile(CASCADE_CFG).todict())
    head_cfg = dict(cfg['model']['roi_head'], train_cfg=cfg['train_cfg'][
        'rcnn'], test_cfg=cfg['test_cfg']['rcnn'])
    ours, theirs = build_head(head_cfg), j_build_head(head_cfg)
    init_weights(ours, torch.Generator().manual_seed(SEED))
    params = state_dict_to_params(ours.state_dict())
    for i in range(STAGES):
        params['bbox_head'][str(i)]['fc_reg']['weight'] *= 100
    ours.load_state_dict(params_to_state_dict(params))
    feats = [rng.randn(B, 64, H // s, W // s).astype(np.float32)
             for s in (4, 8, 16, 32)]
    gt, gvalid, glabels = _ground_truth(rng)
    props, pvalid = _proposals(rng, gt, gvalid)
    for stage in range(STAGES):
        prio = [rng.uniform(size=G + NUM).astype(np.float32)
                for _ in range(2)]
        _patch_jax(theirs.samplers[stage], *prio)
        _patch_torch(ours.samplers[stage], *prio)
    theirs.bbox_roi_extractor = [_RoIsWithoutGradient(e)
                                 for e in theirs.bbox_roi_extractor]
    jrois, trois = [], []
    theirs._bbox_forward = _recording(theirs._bbox_forward, jrois)
    ours._bbox_forward = _recording(ours._bbox_forward, trois)
    args = (props, pvalid, gt, gvalid, glabels)

    def losses(p, f):
        out = theirs.forward_train(
            p, f, *(jnp.asarray(a) for a in args), jax.random.PRNGKey(0),
            img_shapes=jnp.asarray(SHAPES))
        return out, list(jrois)

    jlogs, jrois = jax.jit(losses, compiler_options=FAST_COMPILE)(
        jax.tree_util.tree_map(jnp.asarray, params),
        [jnp.asarray(f.transpose(0, 2, 3, 1)) for f in feats])
    tlogs = ours.forward_train(
        [torch.from_numpy(f) for f in feats],
        *(torch.from_numpy(a) for a in args), torch.Generator(),
        img_shapes=torch.from_numpy(SHAPES))
    return dict(jlogs={k: float(v) for k, v in jlogs.items()},
                tlogs={k: float(v.detach()) for k, v in tlogs.items()},
                jrois=[np.asarray(r) for r in jrois],
                trois=[r.detach().numpy() for r in trois])


@pytest.mark.parametrize('stage', range(STAGES))
def test_cascade_stage_matches_jax(head_run, stage):
    """Stage ``stage``'s sampled RoIs (for stages 1 and 2 the previous
    stage's samples regressed by its own head and coder) within 1e-4 of the
    JAX head's, slot by slot, and its losses (targets encoded with its own
    coder, scaled by its weight) within rtol 1e-4; each stage samples
    positives that are not gts, with a box loss of their regression."""
    got, want = head_run['trois'][stage], head_run['jrois'][stage]
    assert got.shape == want.shape == (B * NUM, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    if stage:
        moved = np.abs(got - head_run['trois'][stage - 1]).max()
        assert moved > 1.0, moved
    for k in ('loss_cls', 'acc', 'loss_bbox'):
        name = f's{stage}.{k}'
        np.testing.assert_allclose(head_run['tlogs'][name],
                                   head_run['jlogs'][name], rtol=1e-4,
                                   err_msg=name)
    assert head_run['tlogs'][f's{stage}.loss_bbox'] > 1e-3


# --------------------------------------------------------------------------
# StandardRoIHead without a sampler: the pseudo sampler
# --------------------------------------------------------------------------

def test_roi_head_without_sampler_matches_jax():
    """A ``StandardRoIHead`` whose ``train_cfg`` names no sampler takes
    every candidate (``PseudoSampler``) on both sides: the same losses on
    the same features and proposals."""
    rng = np.random.RandomState(4)
    head_cfg = dict(
        type='StandardRoIHead',
        bbox_roi_extractor=dict(type='SingleRoIExtractor',
                                roi_layer=dict(type='RoIAlign', out_size=7,
                                               sample_num=0),
                                out_channels=8, featmap_strides=[4, 8]),
        bbox_head=dict(type='Shared2FCBBoxHead', in_channels=8,
                       fc_out_channels=16, num_classes=80),
        train_cfg=dict(assigner=dict(type='MaxIoUAssigner', pos_iou_thr=0.5,
                                     neg_iou_thr=0.5, min_pos_iou=0.5,
                                     match_low_quality=False)),
        test_cfg=dict(score_thr=0.05, nms=dict(type='nms', iou_thr=0.5),
                      max_per_img=100))
    ours, theirs = build_head(head_cfg), j_build_head(head_cfg)
    assert type(ours.sampler).__name__ == 'PseudoSampler'
    params = perturb_free_init(ours)
    feats = [rng.randn(B, 8, H // s, W // s).astype(np.float32)
             for s in (4, 8)]
    gt, gvalid, glabels = _ground_truth(rng)
    xy = rng.uniform(0, [W - 40, H - 40], (B, 30, 2))
    props = np.concatenate([xy, xy + rng.uniform(5, 40, (B, 30, 2)),
                            rng.uniform(size=(B, 30, 1))],
                           -1).astype(np.float32)
    props[:, :6, :4] = gt[:, :6] + 1.0       # near the gts: positives
    pvalid = np.ones((B, 30), bool)
    pvalid[:, -4:] = False
    got = ours.forward_train(
        [torch.from_numpy(f) for f in feats],
        *(torch.from_numpy(a) for a in (props, pvalid, gt, gvalid, glabels)),
        torch.Generator())
    want = jax.jit(lambda p, f: theirs.forward_train(
        p, f, *(jnp.asarray(a) for a in (props, pvalid, gt, gvalid,
                                         glabels)), jax.random.PRNGKey(0)),
        compiler_options=FAST_COMPILE)(
            jax.tree_util.tree_map(jnp.asarray, params),
            [jnp.asarray(f.transpose(0, 2, 3, 1)) for f in feats])
    assert sorted(got) == sorted(want) == ['acc', 'loss_bbox', 'loss_cls']
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-4, err_msg=k)
    assert float(got['loss_bbox'].detach()) > 0


def perturb_free_init(module):
    """A module's seeded random weights, as a JAX parameter tree."""
    from arfe_tpu_torch.layers import init_weights
    init_weights(module, torch.Generator().manual_seed(0))
    return state_dict_to_params(module.state_dict())


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
    """Four PNGs through the JAX package's ``single_device_test`` (two
    images a batch, with the run's compiled program; its results seed the
    ground truth) and ``evaluate``, and through the port's ``test`` CLI in
    process (``--device cpu --eval bbox``) with the tiny detector's weights
    in a ``.pth``."""
    root = str(tmp_path_factory.mktemp('cascade'))
    images = synthetic.write_images(root, SIZES, seed=11)
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

    cfg = tiny_cascade(Config.fromfile(PORT_CFG).todict())
    cfg['data'].update(test=_data_cfg(root), workers_per_gpu=0)
    config = os.path.join(root, 'cfg.py')
    _write_config(config, cfg)
    model = init_detector(Config(cfg), device='cpu')
    model.load_state_dict(params_to_state_dict(run['params']))
    ckpt = save_checkpoint(os.path.join(root, 'cascade.pth'), model)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        stats = test_cli.main([config, ckpt, '--device', 'cpu', '--eval',
                               'bbox'])
    return dict(stats=stats, jstats=jstats, printed=printed.getvalue())


def test_cascade_stats_match_jax(stack):
    """The six bbox stats of the CLI within 1e-6 of the JAX package's, the
    mAP inside (0.05, 0.999), and printed."""
    got, want = stack['stats'], stack['jstats']
    assert sorted(got) == sorted(want) == sorted(STATS)
    assert 0.05 < want['bbox_mAP'] < 0.999, want
    for k in STATS:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
        assert f'{k}: ' in stack['printed']
