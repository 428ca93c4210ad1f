"""Cascade Mask R-CNN (``configs/cascade_rcnn/cascade_mask_rcnn_r50_fpn_1x_
coco.py``) in the port against the JAX package on the CPU: three stages,
each with its own mask head (``roi_head.mask_head.{i}``) trained on its own
sampled positives, ``s{i}.loss_mask`` scaled by the stage's weight; served,
it gives boxes only, as the JAX package's ``simple_test``.

The detector is cut as ``test_torch_cascade.tiny_cascade`` cuts Cascade
R-CNN (R18, 64-channel FPN, 64 proposals and samples a stage), the mask
branch at 64 channels. Both sides start from the port's weights seeded with
``test_torch_cascade.SEED``, BatchNorm statistics perturbed and the
classifiers spread; the samplers of the RPN and of each stage get the same
numpy priorities, the JAX instance's RoIs enter its extractors without
gradient, and both take the same random 28 x 28 gt mask crops. Losses within
rtol 1e-4, gradients within 1e-4 + 1e-3 of their largest |g|, detections by
``test_torch_cascade.detections_match``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_detector as det
import torch
from test_torch_arrff import FAST_COMPILE
from test_torch_c4 import perturb_norms
from test_torch_cascade import (NUM, SEED, STAGES, _fix_stage_priorities,
                                detections_match)
from test_torch_train import (B, G, H, SHAPES, W, _ground_truth,
                              _RoIsWithoutGradient)
from test_torch_threads import one_torch_thread  # noqa: F401

from arfe_tpu.config import Config as JConfig
from arfe_tpu.convert import state_dict_to_params
from arfe_tpu.models import build_detector as j_build_detector
from arfe_tpu.train import parse_losses as j_parse_losses
from arfe_tpu_torch.apis import init_detector
from arfe_tpu_torch.config import Config
from arfe_tpu_torch.convert import params_to_state_dict
from arfe_tpu_torch.layers import init_weights
from arfe_tpu_torch.models import build_detector
from arfe_tpu_torch.train import parse_losses
from arfe_tpu_torch.train.bench import num_anchors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, 'configs', 'cascade_rcnn',
                   'cascade_mask_rcnn_r50_fpn_1x_coco.py')
LOSSES = ['loss_rpn_cls', 'loss_rpn_bbox'] + [
    f's{i}.{k}' for i in range(STAGES)
    for k in ('loss_cls', 'acc', 'loss_bbox', 'loss_mask')] + ['loss']


def tiny_cascade_mask(cfg):
    """R18, a 64-channel FPN and RPN, ``NUM`` proposals, each stage's bbox
    head at 64 channels with 128-wide FCs sampling ``NUM`` RoIs, and each
    stage's mask head at 64 channels (its 4 convs and 80 classes kept)."""
    mc = cfg['model']
    mc.pop('pretrained', None)
    mc['backbone']['depth'] = 18
    mc['neck'].update(in_channels=[64, 128, 256, 512], out_channels=64)
    mc['rpn_head'].update(in_channels=64, feat_channels=64)
    head = mc['roi_head']
    head['bbox_roi_extractor']['out_channels'] = 64
    for h in head['bbox_head']:
        h.update(in_channels=64, fc_out_channels=128)
    head['mask_roi_extractor']['out_channels'] = 64
    head['mask_head'].update(in_channels=64, conv_out_channels=64)
    tc = cfg['train_cfg']
    tc['rpn']['sampler']['num'] = 64
    tc['rpn_proposal'].update(nms_pre=100, nms_post=NUM, max_num=NUM)
    for stage in tc['rcnn']:
        stage['sampler']['num'] = NUM
    cfg['test_cfg']['rpn'].update(nms_pre=100, nms_post=NUM, max_num=NUM)
    return cfg


@pytest.fixture(scope='module')
def run():
    """The tiny Cascade Mask R-CNN on both sides: detections of two 128x160
    images, and one ``forward_train`` + gradient."""
    rng = np.random.RandomState(0)
    cfg = tiny_cascade_mask(Config.fromfile(CFG).todict())
    model = init_detector(Config(cfg), device='cpu')
    init_weights(model, torch.Generator().manual_seed(SEED))
    params = perturb_norms(state_dict_to_params(model.state_dict()), rng)
    params['rpn_head']['rpn_cls']['weight'] *= 8
    for i in range(STAGES):
        head = params['roi_head']
        head['bbox_head'][str(i)]['fc_cls']['weight'] *= 60
        head['mask_head'][str(i)]['conv_logits']['weight'] *= 100
    img = (rng.randn(B, H, W, 3) * 0.2).astype(np.float32)
    gt, gvalid, glabels = _ground_truth(rng)
    crops = (rng.uniform(size=(B, G, 28, 28)) > 0.5).astype(np.float32)

    tm = build_detector(cfg['model'], train_cfg=cfg['train_cfg'],
                        test_cfg=cfg['test_cfg'])
    tm.load_state_dict(params_to_state_dict(params), strict=True)
    tm.eval()
    jcfg = tiny_cascade_mask(JConfig.fromfile(CFG).todict())
    jm = j_build_detector(jcfg['model'], train_cfg=jcfg['train_cfg'],
                          test_cfg=jcfg['test_cfg'])
    _fix_stage_priorities(jm, tm, rng, num_anchors(tm, H, W))
    head = jm.roi_head
    head.bbox_roi_extractor = [_RoIsWithoutGradient(e)
                               for e in head.bbox_roi_extractor]
    head.mask_roi_extractor = [_RoIsWithoutGradient(e)
                               for e in head.mask_roi_extractor]

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jargs = [jnp.asarray(a) for a in (img, SHAPES, gt, gvalid, glabels)]

    def served_and_trained(p):
        out = jm.simple_test(p, jargs[0], jargs[1], jnp.asarray(det.SCALES),
                             rescale=True)
        return out, jax.value_and_grad(
            lambda q: j_parse_losses(jm.forward_train(
                q, *jargs, jax.random.PRNGKey(0),
                gt_mask_crops=jnp.asarray(crops))), has_aux=True)(p)

    jout, ((_, jlogs), jgrads) = jax.jit(
        served_and_trained, compiler_options=FAST_COMPILE)(jp)
    tout = tm.simple_test(*(torch.from_numpy(a) for a in
                            (img, SHAPES, det.SCALES)), rescale=True)
    tm.train()
    total, tlogs = parse_losses(tm.forward_train(
        *[torch.from_numpy(a) for a in (img, SHAPES, gt, gvalid, glabels)],
        torch.Generator().manual_seed(0),
        gt_mask_crops=torch.from_numpy(crops)))
    total.backward()
    to_np = lambda xs: [np.asarray(x) for x in xs]  # noqa: E731
    return dict(
        tm=tm, jax=dict(dets=to_np(jout)), torch=dict(dets=to_np(tout)),
        jlogs={k: float(v) for k, v in jlogs.items()},
        tlogs={k: float(v.detach()) for k, v in tlogs.items()},
        jgrads=params_to_state_dict(jax.tree_util.tree_map(np.array,
                                                           jgrads)))


def test_tiny_cascade_mask_builds(run):
    """A mask head a stage, ``roi_head.mask_head.{i}``; RoIAlign launches:
    a stage's one a request, two a step; boxes only served."""
    tm = run['tm']
    head = tm.roi_head
    assert type(head).__name__ == 'CascadeRoIHead' and head.with_mask
    assert len(head.mask_head) == STAGES
    assert all(e.out_size == (14, 14) for e in head.mask_roi_extractor)
    assert all(f'roi_head.mask_head.{i}.conv_logits.weight'
               in tm.state_dict() for i in range(STAGES))
    assert (tm.num_extractions, tm.num_step_extractions) == (3, 6)
    assert not tm.serves_masks and len(run['torch']['dets']) == 3


def test_tiny_cascade_mask_detections_match_jax(run):
    """Boxes only, as the JAX package's ``simple_test``, matched by
    ``test_torch_cascade.detections_match``."""
    assert len(run['jax']['dets']) == 3
    detections_match(run['jax'], run['torch'])


@pytest.mark.parametrize('name', LOSSES)
def test_tiny_cascade_mask_losses_match_jax(run, name):
    """Each stage's losses, ``s{i}.loss_mask`` among them, scaled by its
    weight, within rtol 1e-4."""
    assert sorted(run['tlogs']) == sorted(run['jlogs']) == sorted(LOSSES)
    assert np.isfinite(run['tlogs'][name])
    np.testing.assert_allclose(run['tlogs'][name], run['jlogs'][name],
                               rtol=1e-4, err_msg=name)


def test_tiny_cascade_mask_gradients_match_jax(run):
    """Every trainable parameter's gradient within 1e-4 + 1e-3 max|g|;
    every stage's mask head has one."""
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
    assert checked > 100 and not bad, bad[:5]
    for i in range(STAGES):
        g = params[f'roi_head.mask_head.{i}.conv_logits.weight'].grad
        assert float(g.abs().max()) > 0
