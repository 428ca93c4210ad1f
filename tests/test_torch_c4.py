"""The C4 detectors (``configs/faster_rcnn/faster_rcnn_r50_caffe_c4_1x_coco.
py``, ``configs/mask_rcnn/mask_rcnn_r50_caffe_c4_1x_coco.py``) in the port
against the JAX package on the CPU: a caffe ResNet-50 cut after stage 3, no
neck, an RPN on its one stride-16 level, RoIAlign at 14 x 14 bins, the
shared ``ResLayer`` head (``layer4``) and an average-pooling ``BBoxHead``;
Mask C4's mask branch shares the bbox extractor and the shared head.

Both are cut as ``tests/test_c4_models.py:19-31`` cuts them (base 8
channels, 128-channel features, 256 out of the shared head), with training
sizes of the tiny flagship; both sides start from the port's seeded
weights, BatchNorm statistics perturbed, the classifiers spread. The
samplers get the same numpy priorities and the JAX instance's RoIs enter
its extractor without gradient (``test_torch_train.py``). Served:
detections by ``test_torch_detector``'s matching rule, Mask C4's mask
logits of matched detections within 1e-3 of the largest; trained: every
loss within rtol 1e-4 and every trainable gradient within 1e-4 + 1e-3 of
its largest |g|, the tolerances of ``test_torch_cascade.py``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_detector as det
import torch
from test_torch_arrff import FAST_COMPILE
from test_torch_train import (B, G, H, SHAPES, W, _ground_truth, _patch_jax,
                              _patch_torch, _RoIsWithoutGradient)
from test_torch_threads import one_torch_thread  # noqa: F401

from arfe_tpu.config import Config as JConfig
from arfe_tpu.convert import state_dict_to_params
from arfe_tpu.models import build_detector as j_build_detector
from arfe_tpu.train import parse_losses as j_parse_losses
from arfe_tpu_torch.apis import init_detector
from arfe_tpu_torch.config import Config
from arfe_tpu_torch.convert import params_to_state_dict
from arfe_tpu_torch.models import build_detector
from arfe_tpu_torch.train import parse_losses
from arfe_tpu_torch.train.bench import num_anchors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = {'faster': 'faster_rcnn/faster_rcnn_r50_caffe_c4_1x_coco.py',
        'mask': 'mask_rcnn/mask_rcnn_r50_caffe_c4_1x_coco.py'}
NUM = 64                  # training proposals and RoI samples per image


def tiny_c4(cfg, mask):
    """``tests/test_c4_models.py:19-31``'s cut of a config dict, with the
    tiny flagship's training sizes (``NUM`` proposals and samples)."""
    mc = cfg['model']
    mc.pop('pretrained', None)
    mc['backbone']['base_channels'] = 8
    mc['rpn_head'].update(in_channels=128, feat_channels=128)
    mc['roi_head']['bbox_roi_extractor']['out_channels'] = 128
    mc['roi_head']['shared_head']['base_channels'] = 8
    mc['roi_head']['bbox_head']['in_channels'] = 256
    if mask:
        mc['roi_head']['mask_head']['in_channels'] = 256
    cfg['test_cfg']['rpn'].update(nms_pre=100, nms_post=50, max_num=50)
    cfg['test_cfg']['rcnn']['max_per_img'] = 10
    tc = cfg['train_cfg']
    tc['rpn']['sampler']['num'] = 64
    tc['rpn_proposal'].update(nms_pre=200, nms_post=NUM, max_num=NUM)
    tc['rcnn']['sampler']['num'] = NUM
    return cfg


def perturb_norms(params, rng):
    """BatchNorm statistics and scales drawn from ``rng`` (at init they are
    the identity)."""
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


def _perturb(params, rng):
    """:func:`perturb_norms`, the RPN's and the RoI head's classifiers and
    the mask logits spread."""
    params = perturb_norms(params, rng)
    params['rpn_head']['rpn_cls']['weight'] *= 8
    params['roi_head']['bbox_head']['fc_cls']['weight'] *= 2
    if 'mask_head' in params['roi_head']:
        params['roi_head']['mask_head']['conv_logits']['weight'] *= 30
    return params


def _runs(name):
    mask = name == 'mask'
    path = os.path.join(REPO, 'configs', CFGS[name])
    rng = np.random.RandomState(0)
    cfg = tiny_c4(Config.fromfile(path).todict(), mask)
    params = _perturb(state_dict_to_params(
        init_detector(Config(cfg), device='cpu').state_dict()), rng)
    img = (rng.randn(B, H, W, 3) * 0.2).astype(np.float32)
    gt, gvalid, glabels = _ground_truth(rng)
    # 25 x 25 crops: at 28 x 28 (or the pipeline's 112 x 112) a gt's own
    # RoI samples its crop half way between pixels for a 14 x 14 target,
    # where two f32 roundings of the same coordinate can put the bilinear
    # value of an edge on either side of the 0.5 threshold
    crops = (rng.uniform(size=(B, G, 25, 25)) > 0.5).astype(np.float32)

    tm = build_detector(cfg['model'], train_cfg=cfg['train_cfg'],
                        test_cfg=cfg['test_cfg'])
    tm.load_state_dict(params_to_state_dict(params), strict=True)
    tm.eval()
    jcfg = tiny_c4(JConfig.fromfile(path).todict(), mask)
    jm = j_build_detector(jcfg['model'], train_cfg=jcfg['train_cfg'],
                          test_cfg=jcfg['test_cfg'])
    n_anchors = num_anchors(tm, H, W)
    prio = [rng.uniform(size=n).astype(np.float32)
            for n in (n_anchors, n_anchors, G + NUM, G + NUM)]
    for m, patch in ((jm, _patch_jax), (tm, _patch_torch)):
        patch(m.rpn_head.sampler, *prio[:2])
        patch(m.roi_head.sampler, *prio[2:])
    head = jm.roi_head
    head.bbox_roi_extractor = _RoIsWithoutGradient(head.bbox_roi_extractor)
    if mask:
        head.mask_roi_extractor = head.bbox_roi_extractor
    kw = dict(gt_mask_crops=crops) if mask else {}

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jargs = [jnp.asarray(a) for a in (img, SHAPES, gt, gvalid, glabels)]

    def served_and_trained(p):
        out = jm.simple_test(p, jargs[0], jargs[1], jnp.asarray(det.SCALES),
                             rescale=True)
        return out, jax.value_and_grad(
            lambda q: j_parse_losses(jm.forward_train(
                q, *jargs, jax.random.PRNGKey(0),
                **{k: jnp.asarray(v) for k, v in kw.items()})),
            has_aux=True)(p)

    jout, ((_, jlogs), jgrads) = jax.jit(
        served_and_trained, compiler_options=FAST_COMPILE)(jp)
    tout = tm.simple_test(*(torch.from_numpy(a) for a in
                            (img, SHAPES, det.SCALES)), rescale=True)
    tm.train()
    total, tlogs = parse_losses(tm.forward_train(
        *[torch.from_numpy(a) for a in (img, SHAPES, gt, gvalid, glabels)],
        torch.Generator().manual_seed(0),
        **{k: torch.from_numpy(v) for k, v in kw.items()}))
    total.backward()
    to_np = lambda xs: [np.asarray(x) for x in xs]  # noqa: E731
    return dict(
        tm=tm, jax=dict(dets=to_np(jout[:3]), out=to_np(jout)),
        torch=dict(dets=to_np(tout[:3]), out=to_np(tout)),
        jlogs={k: float(v) for k, v in jlogs.items()},
        tlogs={k: float(v.detach()) for k, v in tlogs.items()},
        jgrads=params_to_state_dict(jax.tree_util.tree_map(np.array,
                                                           jgrads)))


@pytest.fixture(scope='module', params=list(CFGS))
def run(request):
    return request.param, _runs(request.param)


def test_tiny_c4_builds(run):
    """No neck, one stride-16 level, the shared head under
    ``roi_head.shared_head.layer4``, the mask branch on the bbox
    extractor."""
    name, r = run
    tm = r['tm']
    assert tm.neck is None
    assert tm.rpn_head.anchor_generator.strides == [(16, 16)]
    head = tm.roi_head
    assert head.bbox_roi_extractor.out_size == (14, 14)
    assert 'roi_head.shared_head.layer4.2.conv3.weight' in tm.state_dict()
    assert head.bbox_head.with_avg_pool
    assert tm.with_mask == (name == 'mask')
    if name == 'mask':
        assert head.mask_roi_extractor is head.bbox_roi_extractor
        assert tm.num_extractions == tm.num_step_extractions == 2
        assert r['torch']['out'][3].shape == (B, 10, 14, 14)


def test_tiny_c4_detections_match_jax(run):
    """``test_torch_detector``'s rule; Mask C4's mask logits of each
    matched detection within 1e-3 of the largest |logit|."""
    name, r = run
    (jd, jl, jv), (td, tl_, tv) = r['jax']['dets'], r['torch']['dets']
    assert td.shape == (B, 10, 5) and tl_.dtype == np.int32
    for i in range(B):
        ref = [k for k in range(len(jd[i])) if jv[i, k]]
        assert len(ref) >= 5 and int(tv[i].sum()) == len(ref)
        used = set()
        for k in ref:
            j = next((j for j in np.nonzero(tv[i])[0]
                      if j not in used and tl_[i, j] == jl[i, k]
                      and det._iou(jd[i, k], td[i, j]) > 0.7
                      and abs(td[i, j, 4] - jd[i, k, 4]) < 1e-2), None)
            assert j is not None, f'image {i}: detection {k} unmatched'
            used.add(j)
            if name == 'mask':
                jmk, tmk = r['jax']['out'][3], r['torch']['out'][3]
                scale = np.abs(jmk[jv]).max()
                assert scale > 1.0
                np.testing.assert_allclose(tmk[i, j], jmk[i, k], rtol=0,
                                           atol=1e-3 * scale)


def test_tiny_c4_losses_match_jax(run):
    name, r = run
    names = ['loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls', 'acc',
             'loss_bbox', 'loss'] + (['loss_mask'] if name == 'mask' else [])
    assert sorted(r['tlogs']) == sorted(r['jlogs']) == sorted(names)
    for k in names:
        assert np.isfinite(r['tlogs'][k])
        np.testing.assert_allclose(r['tlogs'][k], r['jlogs'][k], rtol=1e-4,
                                   err_msg=k)


def test_tiny_c4_gradients_match_jax(run):
    """Every trainable parameter's gradient within 1e-4 + 1e-3 max|g|; the
    shared head's last block and the classifier have one."""
    _, r = run
    bad, checked = [], 0
    params = dict(r['tm'].named_parameters())
    for name, p in params.items():
        if not p.requires_grad:
            continue
        want, got = r['jgrads'][name].numpy(), p.grad.numpy()
        tol = 1e-4 + 1e-3 * np.abs(want).max()
        err = np.abs(got - want).max()
        if not err <= tol:
            bad.append((name, float(err), float(tol)))
        checked += 1
    assert checked > 100 and not bad, bad[:5]
    for name in ('roi_head.shared_head.layer4.2.conv3.weight',
                 'roi_head.bbox_head.fc_cls.weight'):
        assert float(params[name].grad.abs().max()) > 0
