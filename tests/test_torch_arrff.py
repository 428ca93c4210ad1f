"""AR-RFF and "+fac" in the port against the JAX package on the CPU: the RoI
helpers, the ARFE cross-entropy variants, the two heads, and the tiny AR-RFF
and "+fac" detectors (``configs/arfe/faster_rcnn_r50_arfpn_{arrff,fac}_1x_
coco.py`` with the overrides of ``__graft_entry__._build_flagship(tiny=True)``)
served and trained, with the same weights (the port's seeded weights
through ``state_dict_to_params``, perturbed, and back through
``params_to_state_dict``), images and ground truth.

The JAX instance gets only what ``test_torch_train.py`` gives it: the
samplers' shared priorities, and no gradient for the RoIs entering its
extractor.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_detector as det
import torch
from test_torch_train import (B, G, H, P, SHAPES, W, _ground_truth,
                              _patch_jax, _patch_torch, stop_roi_gradient)
from test_torch_threads import one_torch_thread  # noqa: F401

from arfe_tpu import Config as JConfig
from arfe_tpu.convert import state_dict_to_params
from arfe_tpu.models import build_detector as j_build_detector
from arfe_tpu.models import losses as jl
from arfe_tpu.models.builder import build_head as j_build_head
from arfe_tpu.models.utils import additional as ja
from arfe_tpu.train import parse_losses as j_parse_losses
from arfe_tpu_torch.apis import init_detector
from arfe_tpu_torch.config import Config
from arfe_tpu_torch.convert import params_to_state_dict
from arfe_tpu_torch.layers import init_weights
from arfe_tpu_torch.models import build_detector
from arfe_tpu_torch.models import losses as tl
from arfe_tpu_torch.models.builder import build_head
from arfe_tpu_torch.models.utils import additional as ta
from arfe_tpu_torch.train import parse_losses

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {name: os.path.join(REPO, 'configs', 'arfe',
                              f'faster_rcnn_r50_arfpn_{name}_1x_coco.py')
           for name in ('arrff', 'fac')}
HEADS = {'arrff': 'MultiRoIsBBoxHead', 'fac': 'Shared2FCMultiClassesBBoxHead'}


def tiny(cfg):
    """A config dict cut as ``__graft_entry__._build_flagship(tiny=True)``
    cuts the flagship: R18, 64 channels, 64 proposals and samples."""
    mc = cfg['model']
    mc.pop('pretrained', None)
    mc['backbone'].update(depth=18, stem_space_to_depth=True)
    mc['neck'][0].update(in_channels=[64, 128, 256, 512], out_channels=64)
    mc['neck'][1]['in_channels'] = 64
    mc['rpn_head'].update(in_channels=64, feat_channels=64)
    mc['roi_head']['bbox_roi_extractor']['out_channels'] = 64
    mc['roi_head']['bbox_head'].update(in_channels=64, fc_out_channels=128)
    tc = cfg['train_cfg']
    tc['rpn']['sampler']['num'] = 64
    tc['rpn_proposal'].update(nms_pre=100, nms_post=64, max_num=64)
    tc['rcnn']['sampler']['num'] = 64
    cfg['test_cfg']['rpn'].update(nms_pre=100, nms_post=64, max_num=64)
    return cfg


# --------------------------------------------------------------------------
# the RoI helpers
# --------------------------------------------------------------------------

def _boxes(n=120, seed=0):
    """RoIs of 0-300 px, a sixth of them thin (1e-3 px or 0 px on one side,
    so that +1 is the whole extent) and some at the image's top left."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 200, (n, 2))
    wh = rng.uniform(0, 300, (n, 2))
    q = n // 6
    wh[:q, 0] = 1e-3
    wh[q:2 * q, 1] = 0.0
    wh[2 * q:3 * q] = rng.uniform(0, 0.5, (q, 2))
    xy[3 * q:4 * q] = rng.uniform(0, 2, (q, 2))
    rois = np.concatenate([rng.randint(0, 2, (n, 1)), xy, xy + wh], -1)
    return rois.astype(np.float32)


@pytest.mark.parametrize('name,kwargs', [
    ('get_large_small_rois', {}), ('get_adaptive_scale_rois', {'facs': 1.0}),
    ('get_adaptive_scale_rois', {'facs': 0.5}), ('get_large_wh_rois', {}),
    ('get_small_wh_rois', {}), ('get_boundary_rois', {}),
    ('get_context_rois', {})])
def test_roi_helpers_match_jax(name, kwargs):
    rois = _boxes()
    want = getattr(ja, name)(jnp.asarray(rois), **kwargs)
    got = getattr(ta, name)(torch.from_numpy(rois), **kwargs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
        # x1 and y1 floored at 0.1, x2 and y2 not
        assert (g[:, 1:3] >= 0.1).all()


def test_adaptive_rois_stretch_as_the_reference():
    """``(adaptive_h, adaptive_w)``: the first keeps the width, the second
    stretches both axes; a wide box is stretched in height."""
    rois = torch.tensor([[0., 100., 100., 139., 109.]])   # 40 x 10 (+1)
    ah, aw = ta.get_adaptive_scale_rois(rois, 1.0)
    h = lambda r: float(r[0, 4] - r[0, 2])                # noqa: E731
    w = lambda r: float(r[0, 3] - r[0, 1])                # noqa: E731
    assert w(ah) == pytest.approx(40.0) and h(ah) == pytest.approx(50.0)
    assert w(aw) == pytest.approx(50.0) and h(aw) == pytest.approx(50.0)


# --------------------------------------------------------------------------
# the ARFE cross-entropy variants
# --------------------------------------------------------------------------

def test_multi_classes_loss_matches_jax():
    """Per image: values and ``jax.grad`` (rtol 1e-5); one image has no
    class present, one every class."""
    rng = np.random.RandomState(3)
    pred = (rng.randn(4, 9, 2) * 2).astype(np.float32)
    presence = (rng.uniform(size=(4, 9)) > 0.6).astype(np.int32)
    presence[1] = 0
    presence[2] = 1
    f = jax.vmap(jl.multi_classes_loss)
    want = jax.jit(f)(jnp.asarray(pred), jnp.asarray(presence))
    jgrad = jax.jit(jax.grad(lambda p: f(p, jnp.asarray(presence)).sum()))(
        jnp.asarray(pred))
    tpred = torch.from_numpy(pred).requires_grad_()
    got = tl.multi_classes_loss(tpred, torch.from_numpy(presence))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5)
    np.testing.assert_allclose(tpred.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize('reduction,avg', [('mean', None), ('mean', 13.0)])
def test_distribution_loss_matches_jax(reduction, avg):
    """Values and ``jax.grad`` (rtol 1e-5); a third of the rows hold tied
    maxima, whose gradient both split evenly."""
    rng = np.random.RandomState(4)
    pred = (rng.randn(30, 6) * 3).astype(np.float32)
    pred[:10] = np.round(pred[:10])
    pred[:10, 0] = pred[:10].max(1)
    label = rng.randint(0, 6, 30).astype(np.int32)
    weight = (rng.uniform(size=30) > 0.3).astype(np.float32)
    args = [jnp.asarray(label), jnp.asarray(weight)]
    want, jgrad = jax.jit(jax.value_and_grad(lambda p: jl.distribution_loss(
        p, *args, reduction=reduction, avg_factor=avg)))(jnp.asarray(pred))
    tpred = torch.from_numpy(pred).requires_grad_()
    got = tl.distribution_loss(tpred, torch.from_numpy(label),
                               torch.from_numpy(weight), reduction=reduction,
                               avg_factor=avg)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(tpred.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-5, atol=1e-7)


def test_cross_entropy_loss_builds_the_variants():
    assert tl.CrossEntropyLoss(use_dis=True).cls_criterion \
        is tl.distribution_loss
    assert tl.CrossEntropyLoss(use_multi_cls=True).cls_criterion \
        is tl.multi_classes_loss
    assert tl.CrossEntropyLoss(use_mask=True).cls_criterion \
        is tl.mask_cross_entropy
    with pytest.raises(ValueError):
        tl.CrossEntropyLoss(use_sigmoid=True, use_mask=True)


# --------------------------------------------------------------------------
# the heads
# --------------------------------------------------------------------------

def _heads(kind, c=16):
    """The ``kind`` head on both sides, from the port's weights seeded with
    1 as a JAX parameter tree (no JAX compilation of the head's ``init``),
    loaded back through ``params_to_state_dict``."""
    cfg = dict(type=HEADS[kind], in_channels=c, fc_out_channels=32,
               roi_feat_size=7, num_classes=5)
    jh = j_build_head(dict(cfg))
    th = build_head(dict(cfg))
    init_weights(th, torch.Generator().manual_seed(1))
    params = state_dict_to_params(th.state_dict())
    th.load_state_dict(params_to_state_dict(params), strict=True)
    return jh, params, th


@pytest.mark.parametrize('kind', ['arrff', 'fac'])
def test_head_forward_matches_jax(kind):
    """(R, 7, 7, 3C) features into ``MultiRoIsBBoxHead``, (R, 7, 7, C) into
    ``Shared2FCMultiClassesBBoxHead`` (2 images); every output to 1e-4."""
    jh, params, th = _heads(kind)
    groups = 3 if kind == 'arrff' else 1
    x = np.random.RandomState(5).randn(12, 7, 7, 16 * groups) \
        .astype(np.float32)
    kw = {} if kind == 'arrff' else {'num_imgs': 2}
    want = jax.jit(lambda p, v: jh(p, v, **kw))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    with torch.no_grad():
        got = th(torch.from_numpy(x), **kw)
    assert len(got) == len(want) == (2 if kind == 'arrff' else 3)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_fac_loss_with_presence_matches_jax():
    """The "+fac" head's losses, ``loss_multi_cls`` among them (rtol
    1e-5)."""
    jh, _, th = _heads('fac')
    rng = np.random.RandomState(6)
    n, k = 2 * 12, 5
    x = dict(cls_score=rng.randn(n, k + 1).astype(np.float32),
             bbox_pred=rng.randn(n, 4 * k).astype(np.float32),
             labels=rng.randint(0, k + 1, n).astype(np.int64),
             label_weights=(rng.uniform(size=n) > 0.2).astype(np.float32),
             bbox_targets=rng.randn(n, 4).astype(np.float32),
             bbox_weights=(rng.uniform(size=(n, 4)) > 0.5)
             .astype(np.float32),
             multi_cls=rng.randn(2, k + 1, 2).astype(np.float32),
             presence=(rng.uniform(size=(2, k + 1)) > 0.5).astype(np.int32))
    want = jax.jit(lambda v: jh.loss(**v))(
        {a: jnp.asarray(v) for a, v in x.items()})
    got = th.loss(**{a: torch.from_numpy(v) for a, v in x.items()})
    assert sorted(got) == sorted(want) and 'loss_multi_cls' in got
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=1e-5)


# --------------------------------------------------------------------------
# the tiny detectors, served and trained
# --------------------------------------------------------------------------

def _jax_detector(kind):
    jcfg = tiny(JConfig.fromfile(CONFIGS[kind]).todict())
    return j_build_detector(jcfg['model'], train_cfg=jcfg['train_cfg'],
                            test_cfg=jcfg['test_cfg'])


# XLA compiles the tiny detectors' programs faster at its lowest
# optimisation level; it runs them a little slower
FAST_COMPILE = {'xla_backend_optimization_level': 0,
                'xla_llvm_disable_expensive_passes': True}


def _port_init(kind):
    """The port's seeded random weights of the tiny ``kind`` detector, as a
    JAX parameter tree (no JAX compilation)."""
    cfg = Config(tiny(Config.fromfile(CONFIGS[kind]).todict()))
    return state_dict_to_params(init_detector(cfg, device='cpu').state_dict())


@pytest.fixture(scope='module')
def trunk():
    """The tiny AR-RFF detector's weights. The "+fac" detector takes its
    backbone, necks and RPN, which are the same modules, with its own RoI
    head's."""
    return _port_init('arrff')


@pytest.fixture(scope='module', params=['arrff', 'fac'])
def run(request, trunk):
    """One config's tiny detector on both sides, from the same weights (the
    port's seeded ones, perturbed): detections of two 128x160 images, and
    one ``forward_train`` + gradient with shared priorities."""
    kind = request.param
    rng = np.random.RandomState(0)
    jm = _jax_detector(kind)
    params = jax.tree_util.tree_map(np.copy, trunk)
    if kind != 'arrff':
        params['roi_head'] = _port_init(kind)['roi_head']
    params = det._perturb(params, rng)
    img = (rng.randn(B, H, W, 3) * 0.2).astype(np.float32)
    gt, gvalid, glabels = _ground_truth(rng)

    cfg = tiny(Config.fromfile(CONFIGS[kind]).todict())
    tm = build_detector(cfg['model'], train_cfg=cfg['train_cfg'],
                        test_cfg=cfg['test_cfg'])
    tm.load_state_dict(params_to_state_dict(params), strict=True)
    tm.eval()
    with torch.no_grad():
        sizes = [tuple(f.shape[2:]) for f in tm.extract_feat(
            torch.from_numpy(img))]
    num_anchors = sum(h * w for h, w in sizes) * tm.rpn_head.num_anchors
    prio = [rng.uniform(size=n).astype(np.float32)
            for n in (num_anchors, num_anchors, G + P, G + P)]
    for m, patch in ((jm, _patch_jax), (tm, _patch_torch)):
        patch(m.rpn_head.sampler, *prio[:2])
        patch(m.roi_head.sampler, *prio[2:])
    stop_roi_gradient(jm)

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

    timg, tshapes, tscales = (torch.from_numpy(a) for a in
                              (img, SHAPES, det.SCALES))
    tdets = tm.simple_test(timg, tshapes, tscales, rescale=True)
    total, tlogs = parse_losses(tm.forward_train(
        *[torch.from_numpy(a) for a in (img, SHAPES, gt, gvalid, glabels)],
        torch.Generator().manual_seed(0)))
    total.backward()
    to_np = lambda xs: [np.asarray(x) for x in xs]  # noqa: E731
    return dict(
        kind=kind, tm=tm, cfg=cfg,
        jax=dict(dets=to_np(jdets)), torch=dict(dets=to_np(tdets)),
        jlogs={k: float(v) for k, v in jlogs.items()},
        tlogs={k: float(v.detach()) for k, v in tlogs.items()},
        jgrads=params_to_state_dict(jax.tree_util.tree_map(np.array,
                                                           jgrads)))


def test_tiny_detector_builds_the_head(run):
    head = run['tm'].roi_head
    assert type(head.bbox_head).__name__ == HEADS[run['kind']]
    assert head.multi_rois == (run['kind'] == 'arrff')
    assert head.with_multi_cls == (run['kind'] == 'fac')


def test_tiny_detections_match_jax(run):
    """The rule of ``test_torch_detector.test_detections_match_jax``."""
    det.test_detections_match_jax(run)


def test_tiny_losses_match_jax(run):
    names = ['loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls', 'acc', 'loss_bbox',
             'loss'] + (['loss_multi_cls'] if run['kind'] == 'fac' else [])
    assert sorted(run['tlogs']) == sorted(run['jlogs']) == sorted(names)
    for name in names:
        assert np.isfinite(run['tlogs'][name])
        np.testing.assert_allclose(run['tlogs'][name], run['jlogs'][name],
                                   rtol=1e-4, err_msg=name)


def test_tiny_gradients_match_jax(run):
    """Every trainable parameter's gradient within 1e-4 + 1e-3 max|g|; the
    head's own convs and ``rpn_reg`` have one."""
    jgrads, checked, bad = run['jgrads'], 0, []
    for name, p in run['tm'].named_parameters():
        if not p.requires_grad:
            continue
        want, got = jgrads[name].numpy(), p.grad.numpy()
        tol = 1e-4 + 1e-3 * np.abs(want).max()
        err = np.abs(got - want).max()
        if not err <= tol:
            bad.append((name, float(err), float(tol)))
        checked += 1
    assert checked > 100 and not bad, bad[:5]
    own = {'arrff': ('hh_conv', 'wh_conv', 'final_conv'),
           'fac': ('spa_conv', 'refine_conv', 'pre_fc', 'multi_cls_reg')}
    grads = dict(run['tm'].named_parameters())
    for name in own[run['kind']] + ('rpn_reg',):
        key = next(k for k in grads if k.endswith(f'{name}.weight')
                   or k.endswith(f'{name}.conv.weight'))
        assert float(grads[key].grad.abs().max()) > 0, key


@pytest.mark.parametrize('kind', ['arrff', 'fac'])
def test_init_detector_builds_the_config(kind):
    """Through the port's own config loader (whose ``_base_`` lists take
    the schedule and the runtime), on the CPU; the card's build is in
    ``chip_smoke.py``."""
    cfg = Config.fromfile(CONFIGS[kind])
    assert cfg.total_epochs == 12 and cfg.optimizer['type'] == 'SGD'
    cfg = Config(tiny(cfg.todict()))
    model = init_detector(cfg, device='cpu', train=True)
    assert type(model.roi_head.bbox_head).__name__ == HEADS[kind]
    assert not model.training and next(model.parameters()).device.type \
        == 'cpu'
