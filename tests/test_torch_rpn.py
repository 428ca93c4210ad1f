"""The RPN detector and the proposals' recall in the port against the JAX
package on the CPU: the tiny RPN of ``configs/rpn/rpn_r50_fpn_1x_coco.py``
(R18, 64-channel FPN) served and trained, the tiny C4 RPN of
``configs/rpn/rpn_r50_caffe_c4_1x_coco.py`` served, both in one JAX
program; ``eval_recalls`` (images without gts or proposals among them)
and ``CocoDataset.evaluate('proposal_fast')`` on the same proposals.

Both sides start from the port's seeded weights, converted; the RPN
samplers get the same numpy priorities (``test_torch_train._patch_*``).
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
from test_torch_fsaf import _boxes
from test_torch_train import (B, H, SHAPES, W, _ground_truth, _patch_jax,
                              _patch_torch)
from test_torch_threads import one_torch_thread  # noqa: F401

from arfe_tpu.config import Config as JConfig
from arfe_tpu.convert import state_dict_to_params
from arfe_tpu.core.evaluation.recall import eval_recalls as j_eval_recalls
from arfe_tpu.data import build_dataset as j_build_dataset
from arfe_tpu.models import build_detector as j_build_detector
from arfe_tpu.train import parse_losses as j_parse_losses
from arfe_tpu_torch.config import Config
from arfe_tpu_torch.convert import params_to_state_dict
from arfe_tpu_torch.core.evaluation import eval_recalls
from arfe_tpu_torch.data import build_dataset, synthetic
from arfe_tpu_torch.layers import init_weights
from arfe_tpu_torch.models import build_detector
from arfe_tpu_torch.train import parse_losses
from arfe_tpu_torch.train.bench import num_anchors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RPN_CFG = os.path.join(REPO, 'configs', 'rpn', 'rpn_r50_fpn_1x_coco.py')
C4_CFG = os.path.join(REPO, 'configs', 'rpn', 'rpn_r50_caffe_c4_1x_coco.py')
NUM = 64                    # proposals an image


def tiny_rpn(cfg):
    """R18 and a 64-channel FPN and head, ``NUM`` proposals from 100
    candidates a level, 64 sampled anchors an image."""
    mc = cfg['model']
    mc.pop('pretrained', None)
    mc['backbone'].update(depth=18, stem_space_to_depth=True)
    mc['neck'].update(in_channels=[64, 128, 256, 512], out_channels=64)
    mc['rpn_head'].update(in_channels=64, feat_channels=64)
    cfg['train_cfg']['rpn']['sampler']['num'] = 64
    cfg['test_cfg']['rpn'].update(nms_pre=100, nms_post=NUM, max_num=NUM)
    return cfg


def tiny_c4_rpn(cfg):
    """The C4 RPN at base 8 channels (one stride-16 level of 128), ``NUM``
    proposals from 300 candidates."""
    mc = cfg['model']
    mc.pop('pretrained', None)
    mc['backbone']['base_channels'] = 8
    mc['rpn_head'].update(in_channels=128, feat_channels=128)
    cfg['test_cfg']['rpn'].update(nms_pre=300, nms_post=NUM, max_num=NUM)
    return cfg


def _port(cfg, rng, seed):
    """The port's detector of ``cfg`` at its seeded weights, BatchNorm
    statistics drawn and the objectness spread, and those weights as a JAX
    tree."""
    tm = build_detector(cfg['model'], train_cfg=cfg['train_cfg'],
                        test_cfg=cfg['test_cfg'])
    init_weights(tm, torch.Generator().manual_seed(seed))
    params = perturb_norms(state_dict_to_params(tm.state_dict()), rng)
    params['rpn_head']['rpn_cls']['weight'] *= 8
    tm.load_state_dict(params_to_state_dict(params), strict=True)
    return tm.eval(), params


@pytest.fixture(scope='module')
def run():
    """Both RPNs on both sides: the FPN form's proposals of two 128x160
    images (rescaled) and one ``forward_train`` + gradient with shared
    priorities, the C4 form's proposals; the JAX sides in one program."""
    rng = np.random.RandomState(0)
    cfg = tiny_rpn(Config.fromfile(RPN_CFG).todict())
    c4_cfg = tiny_c4_rpn(Config.fromfile(C4_CFG).todict())
    tm, params = _port(cfg, rng, 1)
    tc4, c4_params = _port(c4_cfg, rng, 2)
    img = (rng.randn(B, H, W, 3) * 0.2).astype(np.float32)
    gt, gvalid, glabels = _ground_truth(rng)

    jcfg = tiny_rpn(JConfig.fromfile(RPN_CFG).todict())
    jm = j_build_detector(jcfg['model'], train_cfg=jcfg['train_cfg'],
                          test_cfg=jcfg['test_cfg'])
    jc4_cfg = tiny_c4_rpn(JConfig.fromfile(C4_CFG).todict())
    jc4 = j_build_detector(jc4_cfg['model'], train_cfg=jc4_cfg['train_cfg'],
                           test_cfg=jc4_cfg['test_cfg'])
    n = num_anchors(tm, H, W)
    prio = [rng.uniform(size=n).astype(np.float32) for _ in range(2)]
    _patch_jax(jm.rpn_head.sampler, *prio)
    _patch_torch(tm.rpn_head.sampler, *prio)
    jargs = [jnp.asarray(a) for a in (img, SHAPES, gt, gvalid, glabels)]
    scales = jnp.asarray(det.SCALES)

    def served_and_trained(p, pc4):
        props = jm.simple_test(p, jargs[0], jargs[1], scales, rescale=True)
        c4 = jc4.simple_test(pc4, jargs[0], jargs[1], scales, rescale=True)
        return props, c4, jax.value_and_grad(
            lambda q: j_parse_losses(jm.forward_train(
                q, *jargs, jax.random.PRNGKey(0))), has_aux=True)(p)
    jprops, jc4props, ((_, jlogs), jgrads) = jax.jit(
        served_and_trained, compiler_options=FAST_COMPILE)(
            *(jax.tree_util.tree_map(jnp.asarray, p)
              for p in (params, c4_params)))

    targs = [torch.from_numpy(a) for a in (img, SHAPES, det.SCALES)]
    tprops = tm.simple_test(*targs, rescale=True)
    tc4props = tc4.simple_test(*targs, rescale=True)
    tm.train()
    total, tlogs = parse_losses(tm.forward_train(
        *[torch.from_numpy(a) for a in (img, SHAPES, gt, gvalid, glabels)],
        torch.Generator().manual_seed(0)))
    total.backward()
    to_np = lambda xs: [np.asarray(x) for x in xs]  # noqa: E731
    return dict(
        tm=tm, tc4=tc4, props=dict(jax=to_np(jprops), torch=to_np(tprops)),
        c4=dict(jax=to_np(jc4props), torch=to_np(tc4props)),
        jlogs={k: float(v) for k, v in jlogs.items()},
        tlogs={k: float(v.detach()) for k, v in tlogs.items()},
        jgrads=params_to_state_dict(jax.tree_util.tree_map(np.array,
                                                           jgrads)))


def test_tiny_rpns_build(run):
    """An ``RPN`` detector over the FPN's five levels, and one over the C4
    stride-16 level without a neck."""
    tm, tc4 = run['tm'], run['tc4']
    assert type(tm).__name__ == type(tc4).__name__ == 'RPN'
    assert tc4.neck is None and tm.num_extractions == 0
    assert tc4.rpn_head.anchor_generator.strides == [(16, 16)]
    assert 'rpn_head.rpn_cls.weight' in tm.state_dict()


@pytest.mark.parametrize('form', ['props', 'c4'])
def test_tiny_rpn_proposals_match_jax(run, form):
    """The rescaled proposals: the same validity, every slot filled, and
    the same boxes in the same order, to f32 rounding (1e-4 relative plus
    1e-3 absolute), with the same scores."""
    (jp, jv), (tp, tv) = run[form]['jax'], run[form]['torch']
    assert tp.shape == jp.shape == (B, NUM, 5)
    np.testing.assert_array_equal(tv, jv)
    assert tv.all()
    np.testing.assert_allclose(tp, jp, rtol=1e-4, atol=1e-3)
    # rescaled: within each original image
    assert (tp[..., 2] <= SHAPES[:, None, 1] / det.SCALES[:, None, 0]
            + 1e-3).all()


RPN_LOSSES = ['loss_rpn_cls', 'loss_rpn_bbox', 'loss']


@pytest.mark.parametrize('name', RPN_LOSSES)
def test_tiny_rpn_losses_match_jax(run, name):
    """Class-agnostic losses within rtol 1e-4."""
    assert sorted(run['tlogs']) == sorted(run['jlogs']) == sorted(RPN_LOSSES)
    assert np.isfinite(run['tlogs'][name]) and run['tlogs'][name] > 0
    np.testing.assert_allclose(run['tlogs'][name], run['jlogs'][name],
                               rtol=1e-4, err_msg=name)


def test_tiny_rpn_gradients_match_jax(run):
    """Every trainable parameter's gradient within 1e-4 + 1e-3 max|g|; the
    head's and the FPN's have one."""
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
    assert checked > 40 and not bad, bad[:5]
    for k in ('rpn_head.rpn_reg.weight', 'rpn_head.rpn_conv.weight',
              'neck.fpn_convs.0.conv.weight'):
        assert float(params[k].grad.abs().max()) > 0, k


# --------------------------------------------------------------------------
# proposal recall
# --------------------------------------------------------------------------

def _recall_inputs(seed=8):
    """Four images' gts and proposals (n, 5): proposals near the gts at
    several IoUs, random ones, unsorted scores; image 2 has no gts, image 3
    no proposals."""
    rng = np.random.RandomState(seed)
    gts, props = [], []
    for i, (m, n) in enumerate([(6, 400), (3, 250), (0, 120), (4, 0)]):
        gt = _boxes(rng, m, 10, 80)
        near = gt[rng.randint(0, max(m, 1), n // 2)] if m else \
            _boxes(rng, n // 2)
        near = near + rng.normal(0, 6, near.shape)
        p = np.concatenate([near, _boxes(rng, n - n // 2)])
        props.append(np.concatenate([p, rng.uniform(size=(n, 1))],
                                    1).astype(np.float32))
        gts.append(gt)
    return gts, props


@pytest.mark.parametrize('nums', [(10, 100, 300), (50, 1000)])
@pytest.mark.parametrize('thrs', [0.5, 'coco'])
@pytest.mark.parametrize('empty', [False, True])
def test_eval_recalls_matches_jax(nums, thrs, empty):
    """Recalls of each budget and threshold within 1e-6 of the JAX
    package's; with ``empty`` images 2 (no gts) and 3 (no proposals) too,
    whose empty IoU matrices the JAX loop puts among the budgets' lists
    (its quirk, kept: the first budget then reads zeros)."""
    gts, props = _recall_inputs()
    if not empty:
        gts, props = gts[:2], props[:2]
    thrs = np.arange(0.5, 0.96, 0.05) if thrs == 'coco' else thrs
    got = eval_recalls(gts, props, list(nums), thrs)
    want = j_eval_recalls(gts, props, list(nums), thrs)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got[0].max() == 0) if empty else (got.max() > 0.3)


def test_proposal_metric_matches_jax(run, tmp_path):
    """``CocoDataset.evaluate`` with ``proposal_fast`` and ``proposal`` on
    the tiny RPN's rescaled proposals (as per-image lists, the form the
    JAX ``_det2json`` takes) over a COCO set of four images, each with gts
    jittered from some of its proposals and random ones: each ``AR@n``
    within 1e-6 of the JAX dataset's, and not all zero."""
    rng = np.random.RandomState(9)
    (tp, tv) = run['props']['torch']
    props = [tp[i % B][tv[i % B]] for i in range(4)]
    images = [dict(id=i + 1, width=240, height=192, file_name=f'{i}.png')
              for i in range(4)]
    anns = []
    for i, p in enumerate(props):
        picked = p[rng.permutation(len(p))[:4], :4]
        boxes = np.concatenate([picked + rng.normal(0, 2, picked.shape),
                                _boxes(rng, 2, 10, 60)])
        for b in boxes:
            b = np.maximum(b, 0)
            anns.append(dict(id=len(anns) + 1, image_id=i + 1,
                             category_id=1,
                             bbox=[float(b[0]), float(b[1]),
                                   float(max(b[2] - b[0], 1)),
                                   float(max(b[3] - b[1], 1))],
                             area=100.0, iscrowd=0))
    ann_file = str(tmp_path / 'ann.json')
    synthetic.write_annotations(ann_file, images, anns)
    pipeline = Config.fromfile(RPN_CFG).todict()['data']['test']['pipeline']
    data = dict(type='CocoDataset', ann_file=ann_file,
                img_prefix=str(tmp_path), pipeline=pipeline)
    ours = build_dataset(data, dict(test_mode=True))
    theirs = j_build_dataset(data, dict(test_mode=True))
    results = [[p] for p in props]
    nums = (10, 30, NUM)
    for metric in ('proposal_fast', 'proposal'):
        got = ours.evaluate(results, metric=metric, proposal_nums=nums)
        want = theirs.evaluate(results, metric=metric, proposal_nums=nums)
        assert sorted(got) == sorted(want) == sorted(f'AR@{n}' for n in nums)
        for k in got:
            assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
        assert got[f'AR@{NUM}'] > 0.2
