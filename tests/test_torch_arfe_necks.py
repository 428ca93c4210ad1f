"""The authors' experimental necks and heads in the port against the JAX
package on the CPU: ``FPNBU``, ``FPNCBAM`` with its ``CbamModule`` and
``FPNRelation`` (forward and gradients, their parameter trees against the
JAX ``init``'s; FPNRelation's reduced relation map against the outer
product it replaces), ``AttRoIsBBoxHead`` over the RoIs of one image and
of two, and the RoI head's box loss with the IoU losses, whose
``reg_decoded_bbox`` neither package reads.

Weights are the port's seeded ones, converted; the JAX side of each case
is one ``jax.jit``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_arrff import FAST_COMPILE
from test_torch_threads import one_torch_thread  # noqa: F401

from arfe_tpu.convert import state_dict_to_params
from arfe_tpu.models.builder import build_head as j_build_head
from arfe_tpu.models.builder import build_neck as j_build_neck
from arfe_tpu_torch.config import Config
from arfe_tpu_torch.convert import params_to_state_dict
from arfe_tpu_torch.layers import init_weights
from arfe_tpu_torch.models.builder import build_head, build_neck
from arfe_tpu_torch.models.necks import FPNRelation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(32, 40), (16, 20), (8, 10), (4, 5)]
IN_CHANNELS = [8, 16, 24, 32]


def _shapes(tree):
    return jax.tree_util.tree_map(lambda x: tuple(x.shape), tree)


def _grads_close(got, want):
    """Gradients within 1e-4 + 1e-3 of each tensor's largest."""
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        w = want[k].numpy()
        tol = 1e-4 + 1e-3 * np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol,
                                   err_msg=k)


def _neck_case(cfg, inputs, seed=0):
    """The neck of ``cfg`` on both sides on NCHW ``inputs``: outputs (NHWC
    numpy) and the gradients of a fixed weighted sum of them, by parameter
    name; also the JAX ``init``'s parameter shapes."""
    ours, theirs = build_neck(cfg), j_build_neck(cfg)
    init_weights(ours, torch.Generator().manual_seed(seed))
    params = state_dict_to_params(ours.state_dict())
    rng = np.random.RandomState(seed + 1)
    outs = ours([torch.from_numpy(x) for x in inputs])
    weights = [rng.randn(*o.shape).astype(np.float32) for o in outs]
    sum(((o * torch.from_numpy(w)).sum() for o, w in zip(outs, weights)),
        torch.zeros(())).backward()
    got_grads = {k: p.grad for k, p in ours.named_parameters()}

    def value(p, xs):
        ys = theirs(p, xs)
        return sum((y * jnp.asarray(w.transpose(0, 2, 3, 1))).sum()
                   for y, w in zip(ys, weights)), ys
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jx = [jnp.asarray(x.transpose(0, 2, 3, 1)) for x in inputs]
    (_, want), jgrads = jax.jit(jax.value_and_grad(value, has_aux=True),
                                compiler_options=FAST_COMPILE)(jp, jx)
    return dict(
        got=[o.detach().numpy().transpose(0, 2, 3, 1) for o in outs],
        want=[np.asarray(w) for w in want], got_grads=got_grads,
        want_grads=params_to_state_dict(jax.tree_util.tree_map(np.array,
                                                               jgrads)),
        params=params,
        init_shapes=_shapes(jax.eval_shape(theirs.init,
                                           jax.random.PRNGKey(0))))


def _fpn_inputs(seed=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, c, h, w).astype(np.float32)
            for c, (h, w) in zip(IN_CHANNELS, SIZES)]


FPN_NECKS = {
    'FPNBU': dict(type='FPNBU', in_channels=IN_CHANNELS, out_channels=16,
                  num_outs=5),
    'FPNCBAM': dict(type='FPNCBAM', in_channels=IN_CHANNELS, out_channels=32,
                    num_outs=5),
}


@pytest.mark.parametrize('name', sorted(FPN_NECKS))
def test_fpn_variant_matches_jax(name):
    """Each output level within 1e-5 of the JAX neck's, every gradient
    within 1e-4 + 1e-3 of its largest, and the parameter tree (names and
    shapes) that of the JAX ``init``: ``bu_convs`` / ``compress_convs``,
    ``cbam_convs.{i}.channel.fc1`` ... ``spatial.conv.conv``."""
    case = _neck_case(FPN_NECKS[name], _fpn_inputs())
    assert len(case['got']) == len(case['want']) == 5
    for g, w in zip(case['got'], case['want']):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    _grads_close(case['got_grads'], case['want_grads'])
    assert _shapes(case['params']) == case['init_shapes']


def test_fpnbu_keeps_its_unpadded_convs():
    """FPNBU's bottom-up convs are 3x3 without padding: a 32 x 40 lateral
    comes out 30 x 38, then is resized to the next level's 16 x 20."""
    neck = build_neck(FPN_NECKS['FPNBU'])
    assert len(neck.bu_convs) == len(neck.compress_convs) == 3
    x = torch.zeros(1, 16, 32, 40)
    assert neck.bu_convs[0](x).shape[2:] == (30, 38)
    assert neck.bu_convs[0].conv.padding == (0, 0)


RELATION = dict(type='FPNRelation', in_channels=16, num_levels=5)


def test_fpn_relation_matches_jax():
    """As the second neck of a list: each of five levels within 1e-5 of the
    JAX neck's (which builds the h*w x h*w outer product), every gradient
    within 1e-4 + 1e-3 of its largest, the parameter tree the JAX
    ``init``'s."""
    rng = np.random.RandomState(3)
    inputs = [rng.randn(2, 16, h, w).astype(np.float32)
              for h, w in SIZES + [(2, 3)]]
    case = _neck_case(RELATION, inputs)
    for g, w in zip(case['got'], case['want']):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    _grads_close(case['got_grads'], case['want_grads'])
    assert _shapes(case['params']) == case['init_shapes']


def test_fpn_relation_reduced_form_is_the_outer_product():
    """``_rel`` (a map times the other's sum over h*w) against the
    reference's row sums of the outer product, computed in float64, on
    maps of the full-width level 2 (50 x 84) of ReLU outputs: within 2e-6
    relative (f32 sums of 4200 terms in either order)."""
    rng = np.random.RandomState(4)
    m1, m2 = (torch.from_numpy(np.maximum(rng.randn(2, 1, 50, 84), 0)
                               .astype(np.float32)) for _ in range(2))
    got = FPNRelation._rel(m1, m2).double()
    v1, v2 = m1.double().reshape(2, -1, 1), m2.double().reshape(2, 1, -1)
    want = ((v1 * v2).sum(-1) / (50 * 84)).reshape(2, 1, 50, 84)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-6,
                               atol=1e-9)


# --------------------------------------------------------------------------
# AttRoIsBBoxHead
# --------------------------------------------------------------------------

ATT_CFG = os.path.join(REPO, 'configs', 'faster_rcnn',
                       'faster_rcnn_r50_fpn_att_1x_visdrone.py')


@pytest.fixture(scope='module')
def att_head():
    """The config's ``AttRoIsBBoxHead`` at 16 channels, 32-wide FCs and
    VisDrone's 12 classes (the config says 80) on both sides, the JAX
    head's outputs and the gradients of a weighted sum of them compiled
    once per RoI count."""
    head = dict(Config.fromfile(ATT_CFG).todict()['model']['roi_head']
                ['bbox_head'], in_channels=16, fc_out_channels=32,
                num_classes=12)
    ours, theirs = build_head(head), j_build_head(head)
    init_weights(ours, torch.Generator().manual_seed(5))
    params = state_dict_to_params(ours.state_dict())
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    rng = np.random.RandomState(6)
    feats = rng.randn(2, 40, 7, 7, 16).astype(np.float32)
    wc, wr = rng.randn(80, 13), rng.randn(80, 4 * 12)

    def value(p, x):
        cls, reg = theirs(p, x)
        r = x.shape[0]
        return (cls * wc[:r]).sum() + (reg * wr[:r]).sum(), (cls, reg)
    jrun = jax.jit(jax.value_and_grad(value, has_aux=True),
                   compiler_options=FAST_COMPILE)

    def case(num_imgs):
        x = feats[:num_imgs].reshape(-1, 7, 7, 16)
        (_, want), jgrads = jrun(jp, jnp.asarray(x))
        ours.zero_grad()
        cls, reg = ours(torch.from_numpy(x))
        r = x.shape[0]
        ((cls * torch.from_numpy(wc[:r]).float()).sum()
         + (reg * torch.from_numpy(wr[:r]).float()).sum()).backward()
        return dict(got=(cls.detach().numpy(), reg.detach().numpy()),
                    want=[np.asarray(w) for w in want],
                    got_grads={k: p.grad.clone()
                               for k, p in ours.named_parameters()},
                    want_grads=params_to_state_dict(
                        jax.tree_util.tree_map(np.array, jgrads)))
    return dict(case=case, params=params, ours=ours, init_shapes=_shapes(
        jax.eval_shape(theirs.init, jax.random.PRNGKey(0))))


@pytest.mark.parametrize('num_imgs', [1, 2])
def test_att_rois_head_matches_jax(att_head, num_imgs):
    """Over one image's 40 RoIs and two images' 80 (attention across both
    images, as the JAX head's): class and box outputs within 1e-5 and every
    gradient within 1e-4 + 1e-3 of its largest; the parameter tree that of
    the JAX ``init`` (``channel_reduction.conv``, ``fc1``)."""
    case = att_head['case'](num_imgs)
    for g, w in zip(case['got'], case['want']):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    _grads_close(case['got_grads'], case['want_grads'])
    assert _shapes(att_head['params']) == att_head['init_shapes']
    assert att_head['ours'].num_roi_groups == 1


def test_att_rois_attends_across_images(att_head):
    """Two images' RoIs together are not each image's alone: the first
    image's outputs change when the second's RoIs join."""
    one = att_head['case'](1)['got'][0]
    two = att_head['case'](2)['got'][0][:40]
    assert np.abs(one - two).max() > 1e-4


# --------------------------------------------------------------------------
# the RoI head's box loss with the IoU losses
# --------------------------------------------------------------------------

@pytest.mark.parametrize('loss', ['IoULoss', 'GIoULoss', 'BoundedIoULoss'])
def test_bbox_head_iou_loss_matches_jax(loss):
    """``BBoxHead.loss`` of the ``faster_rcnn_r50_fpn_{iou,giou,bounded_
    iou}`` head (``reg_decoded_bbox=True``, read by neither package: the
    loss compares the encoded deltas) on sampled targets: ``loss_bbox``
    within rtol 1e-4 of the JAX head's, and its gradient with respect to
    ``bbox_pred`` within 1e-4 + 1e-3 of the largest."""
    name = {'IoULoss': 'iou', 'GIoULoss': 'giou',
            'BoundedIoULoss': 'bounded_iou'}[loss]
    cfg = Config.fromfile(os.path.join(
        REPO, 'configs', 'faster_rcnn',
        f'faster_rcnn_r50_fpn_{name}_1x_coco.py')).todict()
    head = dict(cfg['model']['roi_head']['bbox_head'], num_classes=6,
                in_channels=8, fc_out_channels=16)
    ours, theirs = build_head(head), j_build_head(head)
    assert ours.reg_decoded_bbox and type(ours.loss_bbox).__name__ == loss
    rng = np.random.RandomState(7)
    n = 64
    cls = rng.randn(n, 7).astype(np.float32)
    pred = (rng.randn(n, 24) * 0.5).astype(np.float32)
    labels = rng.randint(0, 7, n)
    is_pos = labels < 6
    targets = np.where(is_pos[:, None], rng.randn(n, 4) * 0.5,
                       0).astype(np.float32)
    lw = np.ones(n, np.float32)
    bw = np.repeat(is_pos[:, None], 4, 1).astype(np.float32)
    tp = torch.from_numpy(pred).requires_grad_()
    got = ours.loss(torch.from_numpy(cls), tp, torch.from_numpy(labels),
                    *(torch.from_numpy(a) for a in (lw, targets, bw)))
    got['loss_bbox'].backward()

    def loss_bbox(p):
        return theirs.loss(jnp.asarray(cls), p, jnp.asarray(labels),
                           *(jnp.asarray(a) for a in (lw, targets, bw))
                           )['loss_bbox']
    want, jgrad = jax.jit(jax.value_and_grad(loss_bbox),
                          compiler_options=FAST_COMPILE)(jnp.asarray(pred))
    np.testing.assert_allclose(got['loss_bbox'].detach().numpy(),
                               np.asarray(want), rtol=1e-4)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(tp.grad.numpy(), jgrad, rtol=0,
                               atol=1e-4 + 1e-3 * np.abs(jgrad).max())
