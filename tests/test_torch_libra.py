"""Libra R-CNN + ARFE and its pieces in the port against the JAX package on
the CPU: the balanced samplers (instance-balanced positives, IoU-balanced
negatives, their combination), OHEM's sampler and hard-mining pass, the
balanced L1 loss, Libra's BFP neck, the tiny Libra + ARFE detector served
and trained, and the R101 configuration's parameter names.

``jax.random`` and ``torch.Generator`` draw different numbers, so both
sides get the same uniform draws: the port's samplers through their
``_uniform`` (``bench.fix_priorities`` for the detector), the JAX package's
by replacing ``jax.random.uniform`` for the call, which hands out the
draws in the order the samplers ask for them. Each side's own ranking code
then builds the priorities from the draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_detector as det
import torch
from test_torch_arrff import FAST_COMPILE
from test_torch_cascade import detections_match, perturb, tiny_trunk
from test_torch_train import (B, G, H, SHAPES, W, _ground_truth, _proposals,
                              stop_roi_gradient)
from test_torch_threads import one_torch_thread  # noqa: F401

from arfe_tpu.config import Config as JConfig
from arfe_tpu.convert import state_dict_to_params
from arfe_tpu.models import build_detector as j_build_detector
from arfe_tpu.models.builder import build_head as j_build_head
from arfe_tpu.models.builder import build_neck as j_build_neck
from arfe_tpu.models.losses.smooth_l1_loss import \
    BalancedL1Loss as JBalancedL1Loss
from arfe_tpu.registry import BBOX_SAMPLERS as J_SAMPLERS
from arfe_tpu.registry import build_from_cfg as j_build_from_cfg
from arfe_tpu.train import parse_losses as j_parse_losses
from arfe_tpu_torch.apis import init_detector
from arfe_tpu_torch.config import Config
from arfe_tpu_torch.convert import params_to_state_dict
from arfe_tpu_torch.core.bbox import RandomSampler
from arfe_tpu_torch.layers import init_weights
from arfe_tpu_torch.models import build_detector
from arfe_tpu_torch.models.builder import build_head, build_neck
from arfe_tpu_torch.models.losses import BalancedL1Loss
from arfe_tpu_torch.registry import BBOX_SAMPLERS, build_from_cfg
from arfe_tpu_torch.train import bench, parse_losses

NUM = 64                      # proposals and samples per image
# The weights' seed, as ``test_torch_cascade.SEED``: at some seeds the tiny
# detector's f32 step is ill-conditioned (at the cascade's 3 the port's own
# f32 gradient of ``neck.0.fpn_convs.1`` is 2.7e-3 of its largest off its
# f64 one, more than the check allows); at 1 no parameter's is above 4e-6.
SEED = 1
LIBRA_SAMPLER = dict(
    type='CombinedSampler', num=32, pos_fraction=0.25,
    pos_sampler=dict(type='InstanceBalancedPosSampler'),
    neg_sampler=dict(type='IoUBalancedNegSampler', floor_thr=-1,
                     floor_fraction=0, num_bins=3))


class SharedDraws:
    """A stand-in for ``jax.random.uniform`` that returns the given rows in
    turn (the key is ignored), each of the shape asked for."""

    def __init__(self, rows):
        self.rows, self.calls = list(rows), 0

    def __call__(self, key, shape=(), *args, **kwargs):
        row = self.rows[self.calls % len(self.rows)]
        self.calls += 1
        assert row.shape == tuple(shape), (row.shape, shape)
        return jnp.asarray(row)


def jax_sampler(theirs, num_gts):
    """The JAX ``theirs.sample`` of one image compiled once, its two draws
    (positives', negatives') taken as arguments through
    :class:`SharedDraws`: ``f(assigned, max_overlaps, hard_scores, pos,
    neg)``."""
    def sample(assigned, overlaps, hard, pos, neg):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, 'uniform', SharedDraws([pos, neg]))
            return theirs.sample(jax.random.PRNGKey(0), assigned,
                                 max_overlaps=overlaps, num_gts=num_gts,
                                 hard_scores=hard)
    return jax.jit(sample, compiler_options=FAST_COMPILE)


def fixed_draws(sampler, draws):
    """The port ``sampler``'s (and a combined one's two samplers') uniform
    draws replaced by ``draws[side]`` (B, N), ``inf`` off the candidates."""
    for s in bench._drawing(sampler):
        s._uniform = lambda g, cand, side: torch.where(
            cand, torch.from_numpy(draws[side]), float('inf'))


# --------------------------------------------------------------------------
# the samplers, image by image against the JAX ones on shared draws
# --------------------------------------------------------------------------

SAMPLERS = {
    'instance_balanced': dict(type='InstanceBalancedPosSampler', num=32,
                              pos_fraction=0.25),
    'iou_balanced': dict(type='IoUBalancedNegSampler', num=32,
                         pos_fraction=0.25, floor_thr=-1, floor_fraction=0,
                         num_bins=3),
    'iou_balanced_floor': dict(type='IoUBalancedNegSampler', num=32,
                               pos_fraction=0.25, floor_thr=0.05,
                               floor_fraction=0.5, num_bins=3),
    'combined': LIBRA_SAMPLER,
    'ohem': dict(type='OHEMSampler', num=32, pos_fraction=0.25,
                 context=None),
    'score_hlr': dict(type='ScoreHLRSampler', num=32, pos_fraction=0.25),
    'random_prior': dict(type='RandomSamplerPrior', num=32,
                         pos_fraction=0.25, neg_pos_ub=2),
}


def _assignment(rng, n=NUM + G, num_gts=6):
    """A (B, n) assignment over ``num_gts`` padded gt slots: image 0 has
    positives of gts 1-4 in counts 20, 3, 9, 1 (slot 6 is padding, matched
    by none), image 1 none; the rest are negatives and a few ignored (-1),
    with IoUs below 0.5 skewed to the low bins, and ties among them.
    Also the max overlaps, hard scores with ties, and two draws per
    image."""
    assigned = np.zeros((B, n), np.int64)
    ious = 0.5 * rng.uniform(size=(B, n)) ** 4
    ious[:, ::7] = 0.25                      # equal IoUs
    pos = np.repeat([1, 2, 3, 4], [20, 3, 9, 1])
    slots = rng.permutation(n)[:len(pos)]
    assigned[0, slots] = pos
    ious[0, slots] = rng.uniform(0.5, 1.0, len(pos))
    assigned[:, rng.permutation(n)[:5]] = -1
    hard = rng.exponential(1.0, (B, n)).astype(np.float32)
    hard[:, 1::9] = 0.75                     # equal scores
    draws = {side: rng.uniform(size=(B, n)).astype(np.float32)
             for side in ('pos', 'neg')}
    return assigned, ious.astype(np.float32), hard, draws


@pytest.mark.parametrize('name', sorted(SAMPLERS))
def test_sampler_matches_jax(name):
    """``inds``, ``is_pos`` and ``valid`` equal to the JAX sampler's, image
    by image, on the same draws, overlaps, hard scores and padded gt
    count; image 1 has no positives."""
    rng = np.random.RandomState(sorted(SAMPLERS).index(name))
    assigned, ious, hard, draws = _assignment(rng)
    ours = build_from_cfg(dict(SAMPLERS[name]), BBOX_SAMPLERS)
    theirs = j_build_from_cfg(dict(SAMPLERS[name]), J_SAMPLERS)
    assert ours.needs_hard_scores == theirs.needs_hard_scores \
        == (name in ('ohem', 'score_hlr'))
    fixed_draws(ours, draws)
    got = ours.sample(None, torch.from_numpy(assigned),
                      max_overlaps=torch.from_numpy(ious), num_gts=6,
                      hard_scores=torch.from_numpy(hard))
    sample = jax_sampler(theirs, 6)
    for i in range(B):
        want = sample(*(jnp.asarray(a[i]) for a in (
            assigned, ious, hard, draws['pos'], draws['neg'])))
        for k in ('inds', 'is_pos', 'valid'):
            np.testing.assert_array_equal(got[k][i].numpy(),
                                          np.asarray(want[k]), err_msg=k)
    assert int(got['is_pos'][0].sum()) == 8 and not got['is_pos'][1].any()
    # without positives, at most one negative under neg_pos_ub
    assert int(got['valid'][1].sum()) == (1 if name == 'random_prior'
                                          else 32)


def test_balanced_samplers_balance():
    """On a skewed assignment the instance-balanced positives take every
    candidate of a gt with few (round robin) where uniform ranking of the
    same draws does not, and the IoU-balanced negatives fill each bin as
    evenly as the bins allow."""
    rng = np.random.RandomState(7)
    assigned, ious, _, draws = _assignment(rng)
    ours = build_from_cfg(dict(LIBRA_SAMPLER), BBOX_SAMPLERS)
    plain = RandomSampler(num=32, pos_fraction=0.25)
    for s in (ours, plain):
        fixed_draws(s, draws)
    args = (torch.from_numpy(assigned),)
    kw = dict(max_overlaps=torch.from_numpy(ious), num_gts=6)
    got, ref = ours.sample(None, *args, **kw), plain.sample(None, *args, **kw)

    def counts(out, i, values, kind, length):
        picked = out['inds'][i][out['valid'][i] & kind(out['is_pos'][i])]
        return np.bincount(values[i][picked.numpy()], minlength=length)
    gt_counts = counts(got, 0, assigned, lambda p: p, 5)
    assert gt_counts[4] == 1 and set(gt_counts[1:4]) <= {2, 3}
    assert gt_counts.sum() == 8
    assert not np.array_equal(counts(ref, 0, assigned, lambda p: p, 5),
                              gt_counts)
    # round robin over the bins: a bin short of the most taken by more than
    # one has given all it has
    bins = np.clip((ious / 0.5 * 3).astype(np.int64), 0, 2)
    for i in range(B):
        have = np.bincount(bins[i][assigned[i] == 0], minlength=3)
        took = counts(got, i, bins, lambda p: ~p, 3)
        assert all(t == h or t >= took.max() - 1
                   for t, h in zip(took, have)), (took, have)
        assert have.min() < took.max() < have.max(), (took, have)


# --------------------------------------------------------------------------
# the balanced L1 loss and the BFP neck
# --------------------------------------------------------------------------

@pytest.mark.parametrize('beta', [1.0, 0.11])
@pytest.mark.parametrize('reduction,avg', [('mean', None), ('mean', 37.0),
                                           ('sum', None), ('none', None)])
def test_balanced_l1_loss_matches_jax(beta, reduction, avg):
    """``BalancedL1Loss`` (alpha 0.5, gamma 1.5, the RoI head's beta 1.0 and
    the RetinaNet head's 0.11) with element weights, within rtol 1e-6 of
    the JAX loss; differences on both sides of beta."""
    rng = np.random.RandomState(int(beta * 100))
    pred = rng.randn(40, 4).astype(np.float32)
    target = (pred + rng.uniform(-2.5, 2.5, (40, 4))).astype(np.float32)
    weight = (rng.uniform(size=(40, 4)) > 0.3).astype(np.float32)
    kw = dict(alpha=0.5, gamma=1.5, beta=beta, loss_weight=2.0)
    got = BalancedL1Loss(**kw)(
        torch.from_numpy(pred), torch.from_numpy(target),
        torch.from_numpy(weight), avg_factor=avg,
        reduction_override=reduction)
    want = JBalancedL1Loss(**kw)(
        jnp.asarray(pred), jnp.asarray(target), jnp.asarray(weight),
        avg_factor=avg, reduction_override=reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize('refine_type', [None, 'conv', 'non_local'])
def test_bfp_matches_jax(refine_type):
    """``BFP`` over five levels at refine level 2 (gathered there, refined,
    scattered back: nearest up below it, max-pooled down at and above it)
    within 1e-5 of the JAX neck, from the port's seeded weights (the
    NonLocal ``conv_out`` made nonzero)."""
    cfg = dict(type='BFP', in_channels=16, num_levels=5, refine_level=2,
               refine_type=refine_type)
    ours, theirs = build_neck(cfg), j_build_neck(cfg)
    init_weights(ours, torch.Generator().manual_seed(1))
    params = state_dict_to_params(ours.state_dict())
    rng = np.random.RandomState(2)
    if refine_type == 'non_local':
        assert sorted(params['refine']) == ['conv_out', 'g', 'phi', 'theta']
        w = params['refine']['conv_out']['conv']['weight']
        params['refine']['conv_out']['conv']['weight'] = rng.normal(
            0, 0.1, w.shape).astype(np.float32)
    ours.load_state_dict(params_to_state_dict(params), strict=True)
    feats = [rng.randn(B, 16, 40 // 2 ** i, 56 // 2 ** i).astype(np.float32)
             for i in range(5)]
    got = ours([torch.from_numpy(f) for f in feats])
    want = jax.jit(theirs.__call__, compiler_options=FAST_COMPILE)(
        jax.tree_util.tree_map(jnp.asarray, params),
        [jnp.asarray(f.transpose(0, 2, 3, 1)) for f in feats])
    for g, w, f in zip(got, want, feats):
        assert g.shape == f.shape
        np.testing.assert_allclose(g.detach().numpy(),
                                   np.asarray(w).transpose(0, 3, 1, 2),
                                   atol=1e-5)


# --------------------------------------------------------------------------
# the configurations: built, and R101's parameter names
# --------------------------------------------------------------------------

CONFIGS = {'libra': bench.LIBRA_CFG, 'libra101': bench.LIBRA101_CFG,
           'libra_retina': bench.LIBRA_RETINA_CFG, 'ohem': bench.OHEM_CFG,
           'bfp': bench.BFP_CFG}


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_config_builds(name):
    """``init_detector`` builds each configuration at full width on the CPU
    with its ``train_cfg``: its neck, its RoI sampler (or none), its
    regression loss."""
    model = init_detector(CONFIGS[name], device='cpu', train=True)
    necks = [type(m).__name__ for m in model.neck]
    refine = {'libra': 'WFPNDualSpatial', 'libra101': 'WFPNDualSpatial',
              'libra_retina': 'BFP', 'bfp': 'BFP'}.get(name)
    assert necks == ['FPN'] + ([refine] if refine else [])
    assert (bench.refine_block(model) is None) == (name == 'ohem')
    sampler = {'libra': 'CombinedSampler', 'libra101': 'CombinedSampler',
               'ohem': 'OHEMSampler', 'bfp': 'RandomSampler'}.get(name)
    assert [type(s).__name__ for s in model.roi_samplers] == \
        ([sampler] if sampler else [])
    head = model.bbox_head if name == 'libra_retina' \
        else model.roi_head.bbox_head
    loss = head.loss_bbox
    assert type(loss).__name__ == ('BalancedL1Loss' if 'libra' in name
                                   else 'L1Loss')
    if name == 'libra_retina':
        assert loss.beta == 0.11 and model.neck[1].refine_level == 1
    if name.startswith('libra') and name != 'libra_retina':
        drawing = [type(s).__name__ for s, _ in bench.sampled_candidates(
            model, G, H, W)]
        assert drawing == ['RandomSampler', 'InstanceBalancedPosSampler',
                           'IoUBalancedNegSampler']
        assert model.rpn_head.sampler.neg_pos_ub == 5


def test_r101_parameter_names_match_jax():
    """The R101 configuration's parameters, converted from the JAX tree's
    shapes (``jax.eval_shape`` of its ``init``), load into the port's
    detector with ``strict=True``: the same names, 23 blocks in stage 3,
    and the same shapes."""
    jcfg = JConfig.fromfile(bench.LIBRA101_CFG).todict()
    jcfg['model'].pop('pretrained')
    jm = j_build_detector(jcfg['model'], train_cfg=jcfg['train_cfg'],
                          test_cfg=jcfg['test_cfg'])
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    state = params_to_state_dict(zeros)
    cfg = Config.fromfile(bench.LIBRA101_CFG).todict()
    model = build_detector(cfg['model'], train_cfg=cfg['train_cfg'],
                           test_cfg=cfg['test_cfg'])
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in state.items()} == want
    blocks = {k.split('.')[2] for k in want if k.startswith('backbone.layer3')}
    assert blocks == {str(i) for i in range(23)}
    model.load_state_dict(state, strict=True)


# --------------------------------------------------------------------------
# OHEM: the hard-mining pass and one step of the RoI head
# --------------------------------------------------------------------------

def test_ohem_step_matches_jax():
    """The OHEM configuration's RoI head (64 channels, 32 samples an image)
    on random features and proposals around the gts: each candidate's hard
    score (its classification loss, from a forward of every candidate
    without gradient) within 1e-5 of the JAX head's; then with the JAX
    scores shared, the same sampled RoIs and losses within rtol 1e-4."""
    rng = np.random.RandomState(3)
    cfg = Config.fromfile(bench.OHEM_CFG).todict()
    head_cfg = cfg['model']['roi_head']
    head_cfg['bbox_roi_extractor']['out_channels'] = 64
    head_cfg['bbox_head'].update(in_channels=64, fc_out_channels=128)
    cfg['train_cfg']['rcnn']['sampler']['num'] = 32
    head_cfg = dict(head_cfg, train_cfg=cfg['train_cfg']['rcnn'],
                    test_cfg=cfg['test_cfg']['rcnn'])
    ours, theirs = build_head(head_cfg), j_build_head(head_cfg)
    assert ours.sampler.needs_hard_scores
    init_weights(ours, torch.Generator().manual_seed(SEED))
    params = state_dict_to_params(ours.state_dict())
    params['bbox_head']['fc_cls']['weight'] *= 30
    ours.load_state_dict(params_to_state_dict(params))
    feats = [rng.randn(B, 64, H // s, W // s).astype(np.float32)
             for s in (4, 8, 16, 32)]
    gt, gvalid, glabels = _ground_truth(rng)
    props, pvalid = _proposals(rng, gt, gvalid)
    args = (props, pvalid, gt, gvalid, glabels)
    jrecord, trecord = {}, {}

    def recording(forward, log):
        def recorded(*a, **kw):
            log.setdefault('rois', []).append(a[-1])
            return forward(*a, **kw)
        return recorded
    jscores = theirs._candidate_hard_scores
    theirs._candidate_hard_scores = \
        lambda *a: jrecord.setdefault('hard', jscores(*a))
    theirs._bbox_forward = recording(theirs._bbox_forward, jrecord)

    def losses(p, f):
        out = theirs.forward_train(p, f, *(jnp.asarray(a) for a in args),
                                   jax.random.PRNGKey(0))
        return out, jrecord['hard'], jrecord['rois'][-1]
    jlogs, jhard, jrois = jax.jit(losses, compiler_options=FAST_COMPILE)(
        jax.tree_util.tree_map(jnp.asarray, params),
        [jnp.asarray(f.transpose(0, 2, 3, 1)) for f in feats])
    jhard = np.array(jhard)

    tscores = ours._candidate_hard_scores

    def shared(*a):
        trecord['hard'] = tscores(*a)
        return torch.from_numpy(jhard)
    ours._candidate_hard_scores = shared
    ours._bbox_forward = recording(ours._bbox_forward, trecord)
    tlogs = ours.forward_train([torch.from_numpy(f) for f in feats],
                               *(torch.from_numpy(a) for a in args),
                               torch.Generator())
    assert trecord['hard'].shape == (B, G + 64)
    assert not trecord['hard'].requires_grad
    np.testing.assert_allclose(trecord['hard'].numpy(), jhard, rtol=1e-5,
                               atol=1e-5)
    # the hard-mining forward over every candidate, then the sampled RoIs'
    assert [r.shape[0] for r in trecord['rois']] == [B * (G + 64), B * 32]
    np.testing.assert_allclose(trecord['rois'][-1].numpy(),
                               np.asarray(jrois), rtol=1e-5, atol=1e-4)
    assert sorted(tlogs) == sorted(jlogs) == ['acc', 'loss_bbox', 'loss_cls']
    for k in jlogs:
        np.testing.assert_allclose(float(tlogs[k].detach()),
                                   float(jlogs[k]), rtol=1e-4, err_msg=k)
    assert float(tlogs['loss_bbox'].detach()) > 0


# --------------------------------------------------------------------------
# the tiny Libra + ARFE detector, served and trained
# --------------------------------------------------------------------------

def tiny_libra(cfg):
    """The tiny trunk (R18, 64-channel FPN and AR-FPN at refine level 3),
    a 64-channel RPN, ``NUM`` proposals, and the head at 64 channels and
    128-wide FCs sampling ``NUM`` RoIs with the balanced samplers."""
    cfg = tiny_trunk(cfg)
    mc = cfg['model']
    mc['rpn_head'].update(in_channels=64, feat_channels=64)
    mc['roi_head']['bbox_roi_extractor']['out_channels'] = 64
    mc['roi_head']['bbox_head'].update(in_channels=64, fc_out_channels=128)
    tc = cfg['train_cfg']
    tc['rpn']['sampler']['num'] = 64
    tc['rpn_proposal'].update(nms_pre=100, nms_post=NUM, max_num=NUM)
    tc['rcnn']['sampler']['num'] = NUM
    cfg['test_cfg']['rpn'].update(nms_pre=100, nms_post=NUM, max_num=NUM)
    return cfg


@pytest.fixture(scope='module')
def run():
    """The tiny Libra + ARFE detector on both sides: detections of two
    128x160 images, and one ``forward_train`` + gradient on the draws of
    ``bench.fix_priorities``, shared with the JAX samplers."""
    rng = np.random.RandomState(0)
    cfg = tiny_libra(Config.fromfile(bench.LIBRA_CFG).todict())
    model = init_detector(Config(cfg), device='cpu')
    init_weights(model, torch.Generator().manual_seed(SEED))
    params = perturb(state_dict_to_params(model.state_dict()), rng,
                     [(('rpn_head', 'rpn_cls'), 8),
                      (('roi_head', 'bbox_head', 'fc_cls'), 30)])
    img = (rng.randn(B, H, W, 3) * 0.2).astype(np.float32)
    gt, gvalid, glabels = _ground_truth(rng)

    tm = build_detector(cfg['model'], train_cfg=cfg['train_cfg'],
                        test_cfg=cfg['test_cfg'])
    tm.load_state_dict(params_to_state_dict(params), strict=True)
    tm.eval()
    bench.fix_priorities(tm, G, H, W)
    rows = []
    for sampler, n in bench.sampled_candidates(tm, G, H, W):
        cand = torch.ones(n, dtype=torch.bool)
        sides = {'InstanceBalancedPosSampler': ['pos'],
                 'IoUBalancedNegSampler': ['neg']}.get(
                     type(sampler).__name__, ['pos', 'neg'])
        rows += [sampler._uniform(None, cand, s).numpy() for s in sides]

    jcfg = tiny_libra(JConfig.fromfile(bench.LIBRA_CFG).todict())
    jm = j_build_detector(jcfg['model'], train_cfg=jcfg['train_cfg'],
                          test_cfg=jcfg['test_cfg'])
    stop_roi_gradient(jm)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jargs = [jnp.asarray(a) for a in (img, SHAPES, gt, gvalid, glabels)]

    def served_and_trained(p):
        dets = jm.simple_test(p, jargs[0], jargs[1], jnp.asarray(det.SCALES),
                              rescale=True)
        return dets, jax.value_and_grad(
            lambda q: j_parse_losses(jm.forward_train(
                q, *jargs, jax.random.PRNGKey(0))), has_aux=True)(p)
    draws = SharedDraws(rows)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, 'uniform', draws)
        jdets, ((_, jlogs), jgrads) = jax.jit(
            served_and_trained, compiler_options=FAST_COMPILE)(jp)

    timg, tshapes = torch.from_numpy(img), torch.from_numpy(SHAPES)
    tdets = tm.simple_test(timg, tshapes, torch.from_numpy(det.SCALES),
                           rescale=True)
    tm.train()
    total, tlogs = parse_losses(tm.forward_train(
        *[torch.from_numpy(a) for a in (img, SHAPES, gt, gvalid, glabels)],
        torch.Generator().manual_seed(0)))
    total.backward()
    return dict(
        tm=tm, draw_calls=draws.calls, rows=rows,
        jax=dict(dets=[np.asarray(x) for x in jdets]),
        torch=dict(dets=[np.asarray(x) for x in tdets]),
        jlogs={k: float(v) for k, v in jlogs.items()},
        tlogs={k: float(v.detach()) for k, v in tlogs.items()},
        jgrads=params_to_state_dict(jax.tree_util.tree_map(np.array,
                                                           jgrads)))


def test_tiny_libra_draws_shared(run):
    """The JAX samplers asked for the four draws of ``fix_priorities`` (the
    RPN's two, the instance-balanced positives', the IoU-balanced
    negatives'), once each, at the port's candidate counts."""
    assert run['draw_calls'] == 4
    assert [r.shape[0] for r in run['rows'][2:]] == [NUM + G] * 2


def test_tiny_libra_detections_match_jax(run):
    detections_match(run['jax'], run['torch'])


LOSSES = ['loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls', 'acc', 'loss_bbox',
          'loss']


@pytest.mark.parametrize('name', LOSSES)
def test_tiny_libra_losses_match_jax(run, name):
    """Each loss (the box loss balanced L1) within rtol 1e-4."""
    assert sorted(run['tlogs']) == sorted(run['jlogs']) == sorted(LOSSES)
    assert np.isfinite(run['tlogs'][name])
    np.testing.assert_allclose(run['tlogs'][name], run['jlogs'][name],
                               rtol=1e-4, err_msg=name)


def test_tiny_libra_gradients_match_jax(run):
    """Every trainable parameter's gradient within 1e-4 + 1e-3 max|g|; the
    refine's attention and the box regression have one."""
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
    for name in ('neck.1.refine.theta.conv.weight',
                 'roi_head.bbox_head.fc_reg.weight'):
        assert float(params[name].grad.abs().max()) > 0, name


def test_fix_priorities_keeps_balanced_ranking(run):
    """After ``bench.fix_priorities`` the detector's combined sampler still
    ranks within gts and IoU bins: on a skewed assignment of its ``NUM +
    G`` candidates it samples as the JAX sampler does on the same draws,
    and not as uniform ranking of those draws does."""
    rng = np.random.RandomState(11)
    n = NUM + G
    assigned = np.zeros((B, n), np.int64)
    assigned[:, :30] = np.repeat([1, 2, 3], [24, 4, 2])
    ious = np.where(assigned > 0, 0.7, rng.uniform(0, 0.5, (B, n)) ** 3 * 4)
    ious = np.minimum(ious, 0.49).astype(np.float32)
    sampler = run['tm'].roi_head.sampler
    kw = dict(max_overlaps=torch.from_numpy(ious), num_gts=G)
    got = sampler.sample(None, torch.from_numpy(assigned), **kw)
    plain = RandomSampler(num=NUM, pos_fraction=0.25)
    plain._uniform = lambda g, cand, side: (
        sampler.pos_sampler if side == 'pos' else sampler.neg_sampler
    )._uniform(g, cand, side)
    ref = plain.sample(None, torch.from_numpy(assigned), **kw)
    sample = jax_sampler(
        j_build_from_cfg(dict(LIBRA_SAMPLER, num=NUM), J_SAMPLERS), G)
    for i in range(B):
        want = sample(jnp.asarray(assigned[i]), jnp.asarray(ious[i]), None,
                      *(jnp.asarray(r) for r in run['rows'][2:]))
        for k in ('inds', 'is_pos', 'valid'):
            np.testing.assert_array_equal(got[k][i].numpy(),
                                          np.asarray(want[k]), err_msg=k)
        pos = got['inds'][i][got['is_pos'][i]].numpy()
        assert np.bincount(assigned[i][pos]).tolist() == [0, 10, 4, 2]
        assert not torch.equal(got['inds'][i], ref['inds'][i])
