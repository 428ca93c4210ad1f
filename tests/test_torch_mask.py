"""Mask R-CNN + AR-FPN (config #5a) in the port against the JAX package on the
CPU: the mask containers and their OpenCV-free rasterising and resizing, the
run-length encoding and mask IoU, the mask targets and the paste, the mask
head with its converted weights and its loss, the train pipeline and collate
with masks, the tiny detector served and trained, and the evaluation with
``segm`` through the dataset, ``single_device_test``, ``inference_detector``
and the ``test`` CLI.

Every input is drawn from numpy seeds. The JAX package rasterises and
resizes through OpenCV, so these tests also hold ``data.image_io`` against
OpenCV 5's outputs. The tiny detector's JAX instance gets what
``test_torch_arrff.py`` gives it (shared sampling priorities, no
gradient for the RoIs entering its extractors), and both sides start from
the port's seeded weights, converted.
"""
import contextlib
import io
import os
import pickle

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_detector as det
import torch
from test_torch_arrff import FAST_COMPILE, tiny
from test_torch_detector import _perturb
from test_torch_eval import _write_config
from test_torch_train import (B, G, H, SHAPES, W, _ground_truth, _patch_jax,
                              _patch_torch, _RoIsWithoutGradient,
                              stop_roi_gradient)

from arfe_tpu.apis.test import encode_mask_results as j_encode_mask_results
from arfe_tpu.apis.test import single_device_test as j_single_device_test
from arfe_tpu.config import Config as JConfig
from arfe_tpu.convert import state_dict_to_params
from arfe_tpu.core import mask as jmask
from arfe_tpu.data import build_dataloader as j_build_dataloader
from arfe_tpu.data import build_dataset as j_build_dataset
from arfe_tpu.data.builder import collate_detection
from arfe_tpu.models import build_detector as j_build_detector
from arfe_tpu.models.builder import build_head as j_build_head
from arfe_tpu.models.losses import cross_entropy_loss as j_ce
from arfe_tpu.train import parse_losses as j_parse_losses
from arfe_tpu_torch.apis import (encode_mask_results, inference_detector,
                                 init_detector, single_device_test)
from arfe_tpu_torch.config import Config
from arfe_tpu_torch.convert import params_to_state_dict
from arfe_tpu_torch.core import mask as tmask
from arfe_tpu_torch.data import (build_dataloader, build_dataset,
                                 collate_train, synthetic)
from arfe_tpu_torch.layers import init_weights
from arfe_tpu_torch.models import build_detector
from arfe_tpu_torch.models.builder import build_head
from arfe_tpu_torch.models.losses import mask_cross_entropy
from arfe_tpu_torch.tools import test as test_cli
from arfe_tpu_torch.train import parse_losses
from arfe_tpu_torch.train.bench import num_anchors
from arfe_tpu_torch.utils import save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MASK_CFG = os.path.join(REPO, 'configs', 'arfe',
                        'mask_rcnn_r50_arfpn_1x_coco.py')
PORT_CFG = os.path.join(REPO, 'arfe_tpu_torch', 'configs',
                        'mask_rcnn_r50_arfpn_1x_coco.py')
TEST_SCALE = (256, 192)
# (h, w): each resizes to at most 256 x 192 and pads to 192 x 256, so the
# JAX side compiles its detector once
SIZES = [(240, 320), (225, 300), (230, 310), (192, 256)]
STATS = [f'{m}_{k}' for m in ('bbox', 'segm')
         for k in ('mAP', 'AP50', 'AP75', 'APs', 'APm', 'APl')]
KINDS = ('convex', 'concave', 'multi', 'collinear', 'outside')


# --------------------------------------------------------------------------
# rasterising and resizing
# --------------------------------------------------------------------------

def _polygon(rng, kind, h, w):
    """One instance's polygons (flat float32 [x0, y0, ...] arrays)."""
    def star(concave):
        c = rng.uniform(0, [w, h])
        k = rng.randint(3 if not concave else 5, 13)
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        r = rng.uniform(1, 0.4 * max(h, w)) * (
            rng.uniform(0.2, 1, k) if concave else 1.0)
        return np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)],
                        1).ravel()
    if kind == 'convex':
        polys = [star(False)]
    elif kind == 'concave':
        polys = [star(True)]
    elif kind == 'multi':
        polys = [star(bool(rng.randint(2))) for _ in range(rng.randint(2, 4))]
    elif kind == 'collinear':
        p, d = rng.uniform(0, [w, h]), rng.uniform(-10, 10, 2)
        polys = [np.concatenate([p + d * t for t in
                                 rng.uniform(-3, 3, rng.randint(3, 6))])]
    else:   # outside: vertices up to a whole image past every border
        k = rng.randint(3, 9)
        polys = [np.stack([rng.uniform(-w, 2 * w, k),
                           rng.uniform(-h, 2 * h, k)], 1).ravel()]
    return [p.astype(np.float32) for p in polys]


@pytest.mark.parametrize('kind', KINDS)
def test_polygon_fill_matches_jax(kind):
    """``PolygonMasks.to_bitmap`` (vertices truncated) and ``ann_to_mask``
    (vertices rounded) bit for bit on 50 seeded instances of each kind, on
    images of 1-120 px a side."""
    rng = np.random.RandomState(KINDS.index(kind))
    filled = 0
    for _ in range(50):
        h, w = rng.randint(1, 121, 2)
        polys = _polygon(rng, kind, h, w)
        got = tmask.PolygonMasks([polys], h, w).to_bitmap()
        want = jmask.PolygonMasks([polys], h, w).to_bitmap()
        np.testing.assert_array_equal(got.masks, want.masks)
        ann = dict(segmentation=[p.tolist() for p in polys])
        np.testing.assert_array_equal(tmask.ann_to_mask(ann, h, w),
                                      jmask.ann_to_mask(ann, h, w))
        filled += int(got.masks.sum() > 0)
    assert filled > 10


def _bitmaps(rng, n=4, h=37, w=53):
    """Instance masks of filled polygons, one empty."""
    polys = [_polygon(rng, 'concave', h, w) for _ in range(n - 1)]
    masks = jmask.PolygonMasks(polys, h, w).to_bitmap().masks
    return np.concatenate([masks, np.zeros((1, h, w), np.uint8)])


@pytest.mark.parametrize('scale', [0.5, 1.7, 3.0, (1333, 800), (100, 60)])
def test_nearest_resizes_match_jax(scale):
    """``rescale`` and ``resize`` (nearest neighbour) bit for bit, flips
    too; an empty set keeps its rescaled size."""
    rng = np.random.RandomState(1)
    masks = _bitmaps(rng)
    ours = tmask.BitmapMasks(masks, 37, 53)
    theirs = jmask.BitmapMasks(masks, 37, 53)
    got, want = ours.rescale(scale), theirs.rescale(scale)
    assert (got.height, got.width) == (want.height, want.width)
    np.testing.assert_array_equal(got.masks, want.masks)
    shape = (int(37 * 2.3), int(53 * 0.7))
    np.testing.assert_array_equal(ours.resize(shape).masks,
                                  theirs.resize(shape).masks)
    for d in ('horizontal', 'vertical'):
        np.testing.assert_array_equal(ours.flip(d).masks,
                                      theirs.flip(d).masks)
    empty = tmask.BitmapMasks([], 37, 53).rescale(scale)
    want_empty = jmask.BitmapMasks([], 37, 53).rescale(scale)
    assert empty.masks.shape == want_empty.masks.shape


def test_crop_and_resize_matches_jax():
    """``crop_and_resize`` and ``to_fixed_crops`` within 1e-6 (OpenCV 5's
    float resize rounds through its IPP back end: within one float32 ulp of
    the port's float64 result), on boxes inside, across and past the
    image's border, thin, and of exactly twice the output."""
    rng = np.random.RandomState(2)
    masks = _bitmaps(rng, n=6)
    # each box starts inside the image (OpenCV refuses an empty patch)
    boxes = np.concatenate([rng.uniform(-10, [52, 36], (20, 2)),
                            rng.uniform(0.3, 60, (20, 2))], 1)
    boxes[:, 2:] += boxes[:, :2]
    boxes[0] = [3.5, 2.2, 3.6, 30.0]          # thin
    boxes[1] = [0, 0, 53, 37]                 # the whole image
    boxes[2] = [5, 5, 5 + 56, 5 + 56]         # twice 28, past the border
    boxes[3] = [52.5, 36.5, 80, 80]           # the last pixel only
    boxes = boxes.astype(np.float32)
    masks = masks[rng.randint(0, 6, len(boxes))]   # one mask per box
    ours, theirs = tmask.BitmapMasks(masks, 37, 53), \
        jmask.BitmapMasks(masks, 37, 53)
    for shape in ((28, 28), (13, 40)):
        got = ours.crop_and_resize(boxes, shape)
        want = theirs.crop_and_resize(boxes, shape)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours.to_fixed_crops(boxes[:6]),
                               theirs.to_fixed_crops(boxes[:6]), atol=1e-6)


def test_paste_matches_jax():
    """``paste_masks_np`` against the JAX package's (OpenCV's resize):
    equal, but for pixels whose OpenCV probability lies within 1e-6 of the
    0.5 threshold (the float resizes round differently); boxes inside,
    across the border, outside, of 1 px, of exactly 28 and 14 px."""
    rng = np.random.RandomState(3)
    n, img_h, img_w = 40, 90, 120
    probs = (1.0 / (1.0 + np.exp(-rng.randn(n, 28, 28) * 3))).astype(
        np.float32)
    probs[0] = 0.5                            # every pixel on the threshold
    xy = rng.uniform(-30, 130, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.2, 80, (n, 2)),
                            rng.uniform(0, 1, (n, 1))], 1)
    boxes[1, :4] = [10, 10, 38, 38]           # 28 x 28: a copy
    boxes[2, :4] = [20.4, 30.6, 34.4, 44.6]   # 14 x 14: a halving
    boxes[3, :4] = [5.2, 5.2, 5.3, 5.3]       # 1 px
    boxes = boxes.astype(np.float32)
    got = tmask.paste_masks_np(probs, boxes, img_h, img_w)
    want = jmask.paste_masks_np(probs, boxes, img_h, img_w)
    assert got.shape == want.shape == (n, img_h, img_w)
    near, differ = 0, 0
    for i in range(n):
        x1, y1, x2, y2 = boxes[i, :4]
        w = max(int(np.round(x2 - x1)), 1)
        h = max(int(np.round(y2 - y1)), 1)
        x1i, y1i = int(np.round(x1)), int(np.round(y1))
        cv = cv2.resize(probs[i], (w, h))
        full = np.zeros((img_h + 2 * 200, img_w + 2 * 200), bool)
        full[200 + y1i:200 + y1i + h, 200 + x1i:200 + x1i + w] = \
            np.abs(cv - 0.5) <= 1e-6
        tie = full[200:200 + img_h, 200:200 + img_w]
        bad = got[i] != want[i]
        assert not (bad & ~tie).any(), i
        near += int(tie.sum())
        differ += int(bad.sum())
    print(f'paste: {differ} pixels differ, all of {near} within 1e-6 of 0.5')
    assert want[1:].sum() > 1000


# --------------------------------------------------------------------------
# run-length encoding, mask IoU, the mask targets
# --------------------------------------------------------------------------

def test_rle_matches_jax():
    """``mask_to_rle`` equal, the round trip exact, ``rle_area`` and
    ``rle_to_bbox`` equal, on masks that start with a 1, are empty or full;
    ``mask_iou`` with crowd gts (IoF) equal."""
    rng = np.random.RandomState(4)
    masks = list(_bitmaps(rng, n=5, h=31, w=29))
    masks += [np.ones((31, 29), np.uint8), np.eye(31, 29, dtype=np.uint8)]
    for m in masks:
        got, want = tmask.mask_to_rle(m), jmask.mask_to_rle(m)
        assert got == want
        np.testing.assert_array_equal(tmask.rle_to_mask(got), m)
        assert tmask.rle_area(got) == jmask.rle_area(want) == int(m.sum())
        assert tmask.rle_to_bbox(got) == jmask.rle_to_bbox(want)
    crowd = np.array([0, 1, 0, 0, 1, 0, 0], bool)
    got = tmask.mask_iou(masks[:5], masks, crowd)
    want = jmask.mask_iou(masks[:5], masks, crowd)
    np.testing.assert_array_equal(got, want)
    assert tmask.mask_iou([], masks).shape == (0, 7)


def test_mask_targets_match_jax():
    """``mask_target_from_crops`` equal, at 28 and 14 cells, on RoIs around,
    inside, across and away from their gt boxes, thin ones too."""
    rng = np.random.RandomState(5)
    s = 60
    crops = np.stack([tmask.BitmapMasks(_bitmaps(rng, 2, 40, 40)[:1], 40, 40)
                      .to_fixed_crops(np.array([[0, 0, 40, 40]],
                                               np.float32))[0]
                      for _ in range(s)])
    gt = np.concatenate([rng.uniform(0, 100, (s, 2)),
                         rng.uniform(8, 90, (s, 2))], 1)
    gt[:, 2:] += gt[:, :2]
    jitter = rng.uniform(-0.4, 0.4, (s, 4)) * (gt[:, 2:] - gt[:, :2])[
        :, [0, 1, 0, 1]]
    rois = gt + jitter
    rois[:5, 2] = rois[:5, 0] + 0.001           # thin
    rois[5:10] += 300                          # away from the gt
    gt, rois = gt.astype(np.float32), rois.astype(np.float32)
    for m in (28, 14):
        want = np.asarray(jax.jit(
            lambda c, g, r: jmask.mask_target_from_crops(c, g, r, m))(
                crops, gt, rois))
        got = tmask.mask_target_from_crops(
            torch.from_numpy(crops), torch.from_numpy(gt),
            torch.from_numpy(rois), m).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < want.mean() < 1 and want[5:10].sum() == 0


# --------------------------------------------------------------------------
# the mask head
# --------------------------------------------------------------------------

HEAD = dict(type='FCNMaskHead', num_convs=4, in_channels=16,
            conv_out_channels=16, num_classes=5)


@pytest.fixture(scope='module')
def heads():
    jh = j_build_head(dict(HEAD))
    params = jax.tree_util.tree_map(np.array, jax.jit(
        jh.init, compiler_options=FAST_COMPILE)(jax.random.PRNGKey(3)))
    th = build_head(dict(HEAD))
    th.load_state_dict(params_to_state_dict(params), strict=True)
    return jh, params, th


def test_mask_head_forward_matches_jax(heads):
    """The JAX package's initialised head (its transposed conv stored as the
    flipped HWIO kernel of the equivalent conv) converted by
    ``params_to_state_dict`` gives its (R, 28, 28, 5) logits within 1e-5;
    converted as an ordinary conv (HWIO -> OIHW, unflipped) it does not."""
    jh, params, th = heads
    x = np.random.RandomState(6).randn(6, 14, 14, 16).astype(np.float32)
    want = np.asarray(jax.jit(jh, compiler_options=FAST_COMPILE)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x)))
    with torch.no_grad():
        got = th(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (6, 28, 28, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    wrong = build_head(dict(HEAD))
    state = params_to_state_dict(params)
    state['upsample.weight'] = torch.from_numpy(np.ascontiguousarray(
        params['upsample']['weight'].transpose(3, 2, 0, 1)))
    wrong.load_state_dict(state)
    with torch.no_grad():
        assert np.abs(wrong(torch.from_numpy(x)).numpy() - want).max() > 1e-3


def test_mask_losses_match_jax(heads):
    """``FCNMaskHead.loss`` (positives only, each RoI's class channel) and
    ``mask_cross_entropy`` (every RoI) against the JAX ones, rtol 1e-5, and
    the ``use_mask`` loss builds the latter."""
    jh, _, th = heads
    rng = np.random.RandomState(7)
    pred = (rng.randn(9, 28, 28, 5) * 2).astype(np.float32)
    target = (rng.rand(9, 28, 28) > 0.5).astype(np.float32)
    labels = rng.randint(0, 5, 9).astype(np.int32)
    pos = rng.rand(9) > 0.4
    want = float(jh.loss(jnp.asarray(pred), jnp.asarray(target),
                         jnp.asarray(labels), jnp.asarray(pos))['loss_mask'])
    got = float(th.loss(torch.from_numpy(pred), torch.from_numpy(target),
                        torch.from_numpy(labels),
                        torch.from_numpy(pos))['loss_mask'])
    assert got == pytest.approx(want, rel=1e-5)
    want = float(j_ce.mask_cross_entropy(jnp.asarray(pred),
                                         jnp.asarray(target),
                                         jnp.asarray(labels)))
    got = float(mask_cross_entropy(torch.from_numpy(pred),
                                   torch.from_numpy(target),
                                   torch.from_numpy(labels)))
    assert got == pytest.approx(want, rel=1e-5)
    assert th.loss_mask.cls_criterion is mask_cross_entropy


# --------------------------------------------------------------------------
# the train pipeline and collate with masks
# --------------------------------------------------------------------------

@pytest.fixture(scope='module')
def polygon_set(tmp_path_factory):
    """4 PNGs at COCO's two shapes, scaled down, 3-6 polygon instances
    each."""
    root = str(tmp_path_factory.mktemp('polygons'))
    synthetic.write_polygon_set(root, [(120, 160), (160, 120)] * 2, seed=3)
    return root


def _train_cfg(root, flip_ratio):
    cfg = Config.fromfile(PORT_CFG).todict()['data']['train']
    cfg.update(ann_file=f'{root}/ann.json', img_prefix=f'{root}/imgs/')
    cfg['pipeline'][3]['flip_ratio'] = flip_ratio
    return cfg


@pytest.mark.parametrize('flip_ratio', [0.0, 1.0])
def test_train_pipeline_with_masks_matches_jax(polygon_set, flip_ratio):
    """``coco_instance.py``'s train pipeline (``LoadAnnotations(with_mask)``
    -> Resize -> RandomFlip -> ...): images, boxes and ``gt_masks`` bit for
    bit with the flip forced off and on; the collate's ``gt_mask_crops``
    (B, 100, 112, 112) within 1e-6 of ``collate_detection``'s."""
    cfg = _train_cfg(polygon_set, flip_ratio)
    ours, theirs = build_dataset(cfg), j_build_dataset(cfg)
    samples, jsamples = [], []
    for i in range(len(ours)):
        got, want = ours[i], theirs[i]
        assert sorted(got) == sorted(want) == ['gt_bboxes', 'gt_labels',
                                               'gt_masks', 'img',
                                               'img_metas']
        for k in ('img', 'gt_bboxes', 'gt_labels'):
            np.testing.assert_array_equal(got[k], want[k])
        assert got['gt_masks'].masks.shape[1:] == got['img_metas'][
            'img_shape'][:2]
        np.testing.assert_array_equal(got['gt_masks'].masks,
                                      want['gt_masks'].masks)
        assert got['gt_masks'].masks.sum() > 0
        samples.append(got)
        jsamples.append(want)
    for pair in ((0, 2), (1, 3)):
        batch = collate_train([samples[i] for i in pair])
        jbatch = collate_detection([jsamples[i] for i in pair],
                                   static_shapes=None)
        assert tuple(batch['gt_mask_crops'].shape) == (2, 100, 112, 112)
        np.testing.assert_allclose(batch['gt_mask_crops'].numpy(),
                                   jbatch['gt_mask_crops'], rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(batch['gt_bboxes'].numpy(),
                                      jbatch['gt_bboxes'])


# --------------------------------------------------------------------------
# the tiny Mask R-CNN, served and trained
# --------------------------------------------------------------------------

def tiny_mask(cfg):
    """``test_torch_arrff.tiny``'s cut of a config dict, the mask branch at
    64 channels too (its 4 convs and 80 classes kept)."""
    cfg = tiny(cfg)
    head = cfg['model']['roi_head']
    head['mask_roi_extractor']['out_channels'] = 64
    head['mask_head'].update(in_channels=64, conv_out_channels=64)
    return cfg


# The weights' seed. At the port's default seed 0 the tiny detector's f32
# gradients of backbone layers 2-4 differ by up to 1.3% of each tensor's
# largest, between the port and JAX as between the port's own f32 and f64
# (JAX's f32 stays within 1e-3 of the port's f64): the f32 step is
# ill-conditioned there (windows of the AR-FPN neck's adaptive max pools hold
# values within 2e-6 of each other, whose pick decides where the gradient
# goes), which says nothing of either implementation. At seed 3 every
# tensor agrees within the tolerance of ``test_torch_arrff.py``.
SEED = 3


def _port_params(cfg, rng):
    """The port's weights seeded with ``SEED`` as a JAX parameter tree,
    perturbed as the detector tests do, the mask logits' conv scaled so that
    masks are not all at the threshold."""
    model = init_detector(Config(cfg), device='cpu')
    init_weights(model, torch.Generator().manual_seed(SEED))
    params = _perturb(state_dict_to_params(model.state_dict()), rng)
    params['roi_head']['mask_head']['conv_logits']['weight'] *= 300
    return params


@pytest.fixture(scope='module')
def run():
    """The tiny Mask R-CNN on both sides: detections and mask logits of two
    128x160 images, and one ``forward_train`` + gradient with shared
    priorities and the same gt mask crops."""
    rng = np.random.RandomState(0)
    cfg = tiny_mask(Config.fromfile(MASK_CFG).todict())
    params = _port_params(cfg, rng)
    img = (rng.randn(B, H, W, 3) * 0.2).astype(np.float32)
    gt, gvalid, glabels = _ground_truth(rng)
    crops = np.stack([tmask.BitmapMasks(_bitmaps(rng, G + 1, 28, 28)[:G],
                                        28, 28).masks
                      for _ in range(B)]).astype(np.float32)

    tm = build_detector(cfg['model'], train_cfg=cfg['train_cfg'],
                        test_cfg=cfg['test_cfg'])
    tm.load_state_dict(params_to_state_dict(params), strict=True)
    tm.eval()
    jcfg = tiny_mask(JConfig.fromfile(MASK_CFG).todict())
    jm = j_build_detector(jcfg['model'], train_cfg=jcfg['train_cfg'],
                          test_cfg=jcfg['test_cfg'])
    n_anchors = num_anchors(tm, H, W)
    n_cands = G + cfg['train_cfg']['rpn_proposal']['nms_post']
    prio = [rng.uniform(size=n).astype(np.float32)
            for n in (n_anchors, n_anchors, n_cands, n_cands)]
    for m, patch in ((jm, _patch_jax), (tm, _patch_torch)):
        patch(m.rpn_head.sampler, *prio[:2])
        patch(m.roi_head.sampler, *prio[2:])
    stop_roi_gradient(jm)
    jm.roi_head.mask_roi_extractor = _RoIsWithoutGradient(
        jm.roi_head.mask_roi_extractor)

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
        tm=tm, params=params, cfg=cfg,
        jax=dict(dets=to_np(jout[:3]), masks=np.asarray(jout[3])),
        torch=dict(dets=to_np(tout[:3]), masks=tout[3].numpy()),
        jlogs={k: float(v) for k, v in jlogs.items()},
        tlogs={k: float(v.detach()) for k, v in tlogs.items()},
        jgrads=params_to_state_dict(jax.tree_util.tree_map(np.array,
                                                           jgrads)))


def test_tiny_mask_rcnn_builds(run):
    head = run['tm'].roi_head
    assert type(run['tm']).__name__ == 'MaskRCNN' and head.with_mask
    assert head.mask_roi_extractor is not head.bbox_roi_extractor
    assert head.mask_roi_extractor.out_size == (14, 14)
    assert run['torch']['masks'].shape == (B, 100, 28, 28)


def test_tiny_mask_detections_match_jax(run):
    """The rule of ``test_torch_detector.test_detections_match_jax``."""
    det.test_detections_match_jax(run)


def test_tiny_mask_logits_match_jax(run):
    """Each JAX detection's mask logits (its label's channel) against those
    of the port detection that matches it (same label, IoU > 0.7, score
    within 1e-2), within 1e-3 of the largest |logit|: the boxes they are
    extracted at agree to f32 rounding, not bit for bit."""
    (jd, jl, jv), (td, tl_, tv) = run['jax']['dets'], run['torch']['dets']
    jmk, tmk = run['jax']['masks'], run['torch']['masks']
    scale = np.abs(jmk[jv]).max()
    assert scale > 1.0
    checked = 0
    for i in range(B):
        used = set()
        for k in np.nonzero(jv[i])[0]:
            j = next(j for j in np.nonzero(tv[i])[0]
                     if j not in used and tl_[i, j] == jl[i, k]
                     and det._iou(jd[i, k], td[i, j]) > 0.7
                     and abs(td[i, j, 4] - jd[i, k, 4]) < 1e-2)
            used.add(j)
            np.testing.assert_allclose(tmk[i, j], jmk[i, k], rtol=0,
                                       atol=1e-3 * scale)
            checked += 1
    assert checked >= 10


def test_tiny_mask_losses_match_jax(run):
    names = ['loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls', 'acc', 'loss_bbox',
             'loss_mask', 'loss']
    assert sorted(run['tlogs']) == sorted(run['jlogs']) == sorted(names)
    for name in names:
        assert np.isfinite(run['tlogs'][name])
        np.testing.assert_allclose(run['tlogs'][name], run['jlogs'][name],
                                   rtol=1e-4, err_msg=name)


def test_tiny_mask_gradients_match_jax(run):
    """Every trainable parameter's gradient within 1e-4 + 1e-3 max|g|; every
    tensor of the mask head has one."""
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
    mask = {k: p for k, p in run['tm'].named_parameters()
            if k.startswith('roi_head.mask_head.')}
    assert len(mask) == 12
    assert all(float(p.grad.abs().max()) > 0 for p in mask.values())


# --------------------------------------------------------------------------
# evaluation: bbox and segm
# --------------------------------------------------------------------------

def _test_pipeline():
    pipeline = Config.fromfile(PORT_CFG).todict()['data']['test']['pipeline']
    pipeline[1]['img_scale'] = TEST_SCALE
    return pipeline


def _data_cfg(root):
    return dict(type='CocoDataset', ann_file=os.path.join(root, 'ann.json'),
                img_prefix=os.path.join(root, 'imgs'),
                pipeline=_test_pipeline())


@pytest.fixture(scope='module')
def stack(run, tmp_path_factory):
    """Four PNGs of polygon instances through the JAX package's
    ``single_device_test`` (its results seed the ground truth, masks too)
    and ``evaluate``, and through the port's ``test`` CLI (in process:
    ``--device cpu --out F.pkl --eval bbox segm``, ``single_device_test``
    and ``evaluate`` inside), with the tiny detector's weights in a
    ``.pth``."""
    root = str(tmp_path_factory.mktemp('instances'))
    images, _ = synthetic.write_polygon_set(root, SIZES, seed=5)
    jcfg = tiny_mask(JConfig.fromfile(MASK_CFG).todict())
    jmodel = j_build_detector(jcfg['model'], test_cfg=jcfg['test_cfg'])
    jloader = j_build_dataloader(
        j_build_dataset(_data_cfg(root), dict(test_mode=True)),
        samples_per_gpu=1, workers_per_gpu=0, shuffle=False,
        static_shapes=None, test_mode=True)
    jresults = j_single_device_test(
        jmodel, jax.tree_util.tree_map(jnp.asarray, run['params']), jloader,
        show_progress=False)
    synthetic.write_annotations(
        os.path.join(root, 'ann.json'), images,
        synthetic.seed_ground_truth(images, jresults))
    jstats = j_build_dataset(_data_cfg(root), dict(test_mode=True)) \
        .evaluate(jresults, metric=['bbox', 'segm'])

    cfg = tiny_mask(Config.fromfile(PORT_CFG).todict())
    cfg['data'].update(test=_data_cfg(root), workers_per_gpu=0)
    config, out = os.path.join(root, 'cfg.py'), os.path.join(root, 'r.pkl')
    _write_config(config, cfg)
    model = init_detector(Config(cfg), device='cpu')
    model.load_state_dict(params_to_state_dict(run['params']))
    ckpt = save_checkpoint(os.path.join(root, 'mask.pth'), model)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        stats = test_cli.main([config, ckpt, '--device', 'cpu', '--out', out,
                               '--eval', 'bbox', 'segm'])
    with open(out, 'rb') as f:
        results = pickle.load(f)
    return dict(root=root, model=model, results=results, stats=stats,
                printed=printed.getvalue(), jresults=jresults,
                jstats=jstats)


def test_stack_stats_match_jax(stack):
    """The twelve bbox and segm stats of the CLI within 1e-6 of the JAX
    package's, each mAP inside (0.05, 0.999)."""
    got, want = stack['stats'], stack['jstats']
    assert sorted(got) == sorted(want) == sorted(STATS)
    for m in ('bbox_mAP', 'segm_mAP'):
        assert 0.05 < want[m] < 0.999, want
    for k in STATS:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])


def test_stack_masks_match_jax(stack):
    """Per image the same detections per class, and the port's RLE masks
    equal to the JAX package's pasted masks encoded, but for pixels next to
    the threshold: each mask within 1% of its area, and most equal."""
    equal, total = 0, 0
    for got, want in zip(stack['results'],
                         j_encode_mask_results(stack['jresults'])):
        (gb, gs), (wb, ws) = got, want
        assert [len(b) for b in gb] == [len(b) for b in wb]
        for c, (gm, wm) in enumerate(zip(gs, ws)):
            np.testing.assert_allclose(gb[c], wb[c], rtol=1e-4, atol=1e-3)
            for a, b in zip(gm, wm):
                a, b = tmask.rle_to_mask(a), tmask.rle_to_mask(b)
                assert int((a != b).sum()) <= 0.01 * max(int(b.sum()), 100)
                equal += int(np.array_equal(a, b))
                total += 1
    assert total >= 20 and equal >= 0.9 * total, (equal, total)


def test_inference_detector_gives_masks(stack):
    """``inference_detector`` on a path and on the BGR array gives the
    loader path's ``(bbox, segm)``: boxes equal, masks equal to the
    decoded RLE."""
    model = stack['model']
    path = os.path.join(stack['root'], 'imgs', '2.png')
    bbox, segm = inference_detector(model, path)
    want_bbox, want_segm = stack['results'][2]
    for a, b in zip(bbox, want_bbox):
        np.testing.assert_array_equal(a, b)
    assert sum(len(s) for s in segm) == sum(len(b) for b in bbox) > 0
    for got, want in zip(segm, want_segm):
        for a, b in zip(got, want):
            assert a.shape == tuple(b['size']) and a.dtype == np.uint8
            np.testing.assert_array_equal(a, tmask.rle_to_mask(b))
    again = inference_detector(model, cv2.imread(path))
    for a, b in zip(again[1], segm):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert encode_mask_results([(bbox, segm)])[0][1] == want_segm


def test_test_cli_prints_segm_stats(stack):
    """The test CLI printed the twelve stats it returned."""
    printed = dict(line.split(': ') for line in stack['printed'].splitlines()
                   if line.startswith(('bbox_', 'segm_')))
    assert sorted(printed) == sorted(stack['stats']) == sorted(STATS)
    for k in STATS:
        assert float(printed[k]) == pytest.approx(stack['stats'][k], abs=1e-4)
