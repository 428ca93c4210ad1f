"""The port's caffe-style ResNet, ResNeXt (both styles), the C4 ``ResLayer``
shared head and mmdet 1.x's ``LegacyDeltaXYWHBBoxCoder`` against the JAX
package on the CPU, with the same weights and seeded numpy inputs; and the
configs these pieces let the port build.

Every module starts from the port's seeded weights (BatchNorm statistics
and scales perturbed) carried to JAX by the JAX package's
``state_dict_to_params``; for ResNeXt that tree must be the JAX package's
own ``init``'s (``jax.eval_shape``, no compilation) and come back through
``convert.params_to_state_dict`` with ``strict=True``: its grouped 3x3
kernels are HWIO (3, 3, C / g, C) there and must arrive as torch's (C, C /
g, 3, 3).
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
from arfe_tpu.core.bbox.coder import LegacyDeltaXYWHBBoxCoder as JLegacy
from arfe_tpu.models.backbones.resnet import Bottleneck as JBottleneck
from arfe_tpu.models.backbones.resnet import ResNet as JResNet
from arfe_tpu.models.backbones.resnext import ResNeXt as JResNeXt
from arfe_tpu.models.roi_heads.shared_heads.res_layer import \
    ResLayer as JResLayer
from arfe_tpu_torch.config import Config
from arfe_tpu_torch.convert import params_to_state_dict
from arfe_tpu_torch.core.bbox import LegacyDeltaXYWHBBoxCoder
from arfe_tpu_torch.data.pipelines import Compose
from arfe_tpu_torch.layers import init_weights
from arfe_tpu_torch.models import build_detector
from arfe_tpu_torch.models.backbones import ResNeXt, ResNet
from arfe_tpu_torch.models.backbones.resnet import Bottleneck
from arfe_tpu_torch.models.roi_heads import ResLayer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 against f32 in another summation order: within ATOL of the output's
# largest |value| (at least 1). Through a ResNet-50's 16 blocks the seeded
# features reach ~30, and single values differ by ~2e-6 of that.
ATOL = 1e-5


def assert_close(got, want):
    np.testing.assert_allclose(
        got, want, rtol=0, atol=ATOL * max(1.0, float(np.abs(want).max())))


def seeded(module, seed=0):
    """``module`` with the port's seeded weights and BatchNorm statistics
    and scales drawn from a numpy seed (at init they are the identity)."""
    init_weights(module, torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if name.endswith('running_mean'):
                t.copy_(torch.from_numpy(rng.normal(0, 0.1, t.shape)))
            elif name.endswith('running_var'):
                t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape)))
            elif name.endswith('weight') and t.dim() == 1:
                t.copy_(torch.from_numpy(rng.normal(1, 0.1, t.shape)))
    return module.eval()


def run_jax(module, params, x):
    """The JAX module on NHWC ``x``; outputs as numpy."""
    out = jax.jit(module.__call__, compiler_options=FAST_COMPILE)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    return [np.asarray(o) for o in (out if isinstance(out, tuple)
                                    else (out,))]


def run_port(module, x):
    """The port's module on the same NHWC ``x`` (read as NCHW); outputs as
    NHWC numpy."""
    with torch.no_grad():
        out = module(torch.from_numpy(x).permute(0, 3, 1, 2))
    return [o.permute(0, 2, 3, 1).numpy() for o in (out if isinstance(
        out, tuple) else (out,))]


def image(shape, seed=1):
    """Seeded numpy input at the bench's image scale (0.2 randn)."""
    return (np.random.RandomState(seed).randn(*shape) * 0.2).astype(
        np.float32)


@pytest.mark.parametrize('style', ['caffe', 'pytorch'])
def test_bottleneck_matches_jax(style):
    """One strided bottleneck with its downsample: caffe style puts the
    stride on conv1, pytorch style on conv2; within ATOL."""
    port = seeded(Bottleneck(32, 16, stride=2, downsample=True, style=style))
    assert port.conv1.stride == ((2, 2) if style == 'caffe' else (1, 1))
    assert port.conv2.stride == ((1, 1) if style == 'caffe' else (2, 2))
    ref = JBottleneck(32, 16, stride=2, downsample=True, style=style)
    x = image((2, 15, 17, 32))
    want = run_jax(ref, state_dict_to_params(port.state_dict()), x)[0]
    got = run_port(port, x)[0]
    assert got.shape == want.shape == (2, 8, 9, 64)
    assert_close(got, want)


def test_caffe_resnet_matches_jax():
    """A tiny caffe ResNet-50 (base 8 channels), every stage's output
    within ATOL, the stem and stage 1 frozen as a config freezes them."""
    kw = dict(depth=50, base_channels=8, style='caffe', frozen_stages=1,
              norm_cfg=dict(type='BN', requires_grad=False))
    port = seeded(ResNet(**kw))
    assert not any(p.requires_grad for p in port.layer1.parameters())
    assert all(p.requires_grad for p in port.layer2.parameters())
    x = image((1, 64, 96, 3))
    want = run_jax(JResNet(**kw), state_dict_to_params(port.state_dict()), x)
    got = run_port(port, x)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert_close(g, w)


@pytest.mark.parametrize('style', ['pytorch', 'caffe'])
def test_resnext_matches_jax(style):
    """A tiny ResNeXt-50 (base 16 channels, 4 groups of width 16 / 64 of a
    stage's planes each: 16, 32, 64, 128 grouped channels), in both styles:
    the port's seeded weights in the JAX package's ``init`` tree (names and
    shapes, the grouped kernels' layout, from ``jax.eval_shape``), loaded
    back with ``strict=True``; every stage within ATOL."""
    kw = dict(depth=50, base_channels=16, groups=4, base_width=16,
              style=style)
    ref = JResNeXt(**kw)
    # the JAX init's parameter tree (names and shapes, without compiling
    # it), filled with the port's seeded weights
    shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
    port = seeded(ResNeXt(**kw))
    params = state_dict_to_params(port.state_dict())
    assert jax.tree_util.tree_map(lambda x: tuple(x.shape), params) == \
        jax.tree_util.tree_map(lambda x: tuple(x.shape), shapes)
    port.load_state_dict(params_to_state_dict(params), strict=True)
    port.eval()
    conv2 = port.layer2[0].conv2
    assert conv2.groups == 4 and tuple(conv2.weight.shape) == (32, 8, 3, 3)
    assert tuple(shapes['layer2']['0']['conv2']['weight'].shape) == \
        (3, 3, 8, 32)
    x = image((1, 64, 96, 3))
    want = run_jax(ref, params, x)
    got = run_port(port, x)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert_close(g, w)


def test_res_layer_matches_jax():
    """The C4 shared head (caffe layer4 of a ResNet-50 at base 8): (R, 14,
    14, 128) RoI features to (R, 7, 7, 256), parameters named
    ``layer4.{j}``, within ATOL."""
    kw = dict(depth=50, stage=3, stride=2, style='caffe', base_channels=8)
    port = seeded(ResLayer(**kw))
    names = port.state_dict()
    assert 'layer4.0.conv1.weight' in names and 'layer4.2.bn3.bias' in names
    ref = JResLayer(**kw)
    x = image((5, 14, 14, 128))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    want = run_jax(ref, state_dict_to_params(port.state_dict()), x)[0]
    assert got.shape == want.shape == (5, 7, 7, 256)
    assert_close(got, want)


def test_legacy_coder_matches_jax():
    """mmdet 1.x's encoding and decoding (+1 widths) against the JAX
    package's within 1e-6 relative: targets of seeded boxes, the round trip
    (which gives the gts grown by 0.5 px a side: the decode drops mmdet
    1.x's -+0.5), and a clamped decode of k = 3 boxes per RoI."""
    rng = np.random.RandomState(2)
    xy = rng.uniform(0, 200, (2, 40, 2))
    props = np.concatenate([xy, xy + rng.uniform(1, 90, xy.shape)], -1)
    gts = props + rng.uniform(-8, 8, props.shape)
    gts[..., 2:] = np.maximum(gts[..., 2:], gts[..., :2] + 1)
    props, gts = props.astype(np.float32), gts.astype(np.float32)
    stds = (0.1, 0.1, 0.2, 0.2)
    port, ref = LegacyDeltaXYWHBBoxCoder(target_stds=stds), \
        JLegacy(target_stds=stds)
    # the JAX coder compiled (op by op, each of its ops compiles)
    encode = jax.jit(ref.encode, compiler_options=FAST_COMPILE)
    decode = jax.jit(ref.decode, static_argnames='max_shape',
                     compiler_options=FAST_COMPILE)
    got = port.encode(torch.from_numpy(props), torch.from_numpy(gts))
    want = np.asarray(encode(jnp.asarray(props), jnp.asarray(gts)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    back = port.decode(torch.from_numpy(props), got)
    want_back = np.asarray(decode(jnp.asarray(props), jnp.asarray(want)))
    np.testing.assert_allclose(back.numpy(), want_back, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(back.numpy(), gts + [-0.5, -0.5, 0.5, 0.5],
                               rtol=1e-6, atol=1e-4)
    deltas = (rng.randn(2, 40, 12) * 0.5).astype(np.float32)
    shapes = np.array([[150., 180.], [120., 200.]], np.float32)
    got = port.decode(torch.from_numpy(props), torch.from_numpy(deltas),
                      max_shape=torch.from_numpy(shapes))
    want = np.stack([np.asarray(decode(
        jnp.asarray(props[i]), jnp.asarray(deltas[i]),
        max_shape=tuple(float(x) for x in shapes[i]))) for i in range(2)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert got[0, :, 0::4].max() <= shapes[0, 1] - 1


#: configs the newer pieces let the port build: ResNet's caffe style,
#: ResNeXt, Cascade Mask R-CNN, the C4 layout and the legacy coder; then
#: the RPN, FSAF and its Faster hybrids (built, not run, as in the JAX
#: package: ``tests/test_zoo_forward.py:32-36``), the IoU losses, the
#: experimental necks, AttRoIs and VisDrone
CONFIGS = [
    'cascade_rcnn/cascade_mask_rcnn_r50_fpn_1x_coco.py',
    'cascade_rcnn/cascade_mask_rcnn_r101_fpn_1x_coco.py',
    'cascade_rcnn/cascade_mask_rcnn_r50_caffe_fpn_1x_coco.py',
    'cascade_rcnn/cascade_mask_rcnn_r101_caffe_fpn_1x_coco.py',
    'cascade_rcnn/cascade_mask_rcnn_x101_32x4d_fpn_1x_coco.py',
    'cascade_rcnn/cascade_mask_rcnn_x101_64x4d_fpn_1x_coco.py',
    'cascade_rcnn/cascade_mask_rcnn_x101_32x4d_fpn_20e_coco.py',
    'cascade_rcnn/cascade_mask_rcnn_x101_64x4d_fpn_20e_coco.py',
    'cascade_rcnn/cascade_mask_rcnn_r50_fpn_20e_coco.py',
    'cascade_rcnn/cascade_mask_rcnn_r101_fpn_20e_coco.py',
    'faster_rcnn/faster_rcnn_r50_caffe_c4_1x_coco.py',
    'mask_rcnn/mask_rcnn_r50_caffe_c4_1x_coco.py',
    'mask_rcnn/mask_rcnn_r50_caffe_fpn_poly_1x_coco_v1.py',
    'rpn/rpn_r50_fpn_1x_coco.py',
    'rpn/rpn_r50_caffe_c4_1x_coco.py',
    'fsaf/fsaf_r50_fpn_1x_coco.py',
    'arfe/faster_fsaf_r50_1x_coco.py',
    'mytrain/faster_fsaf_r50_coco.py',
    'mytrain/faster_rcnn_r50_fsaf_1x_coco.py',
    'faster_rcnn/faster_rcnn_r50_fpn_iou_1x_coco.py',
    'faster_rcnn/faster_rcnn_r50_fpn_giou_1x_coco.py',
    'faster_rcnn/faster_rcnn_r50_fpn_bounded_iou_1x_coco.py',
    'arfe/faster_rcnn_r50_fpn_bu_1x_coco.py',
    'arfe/faster_rcnn_r50_fpn_relation_1x_coco.py',
    'faster_rcnn/faster_rcnn_r50_fpn_1x_rel_visfrone.py',
    'mytrain/faster_rcnn_r50_fpn_cbam_1x_coco.py',
    'faster_rcnn/faster_rcnn_r50_fpn_att_1x_visdrone.py',
    'mytrain/faster_rcnn_r50_fpn_multicls_1x_visdrone.py',
]


@pytest.mark.parametrize('path', CONFIGS)
def test_config_builds(path):
    """The detector of the config, with its ``train_cfg``, on the meta
    device (no weights are made), and its train and test pipelines."""
    cfg = Config.fromfile(os.path.join(REPO, 'configs', path)).todict()
    model_cfg = dict(cfg['model'])
    model_cfg.pop('pretrained', None)
    with torch.device('meta'):
        model = build_detector(model_cfg, train_cfg=cfg['train_cfg'],
                               test_cfg=cfg['test_cfg'])
    # a list-valued data.train (VisDrone's) is a pipeline a dataset; the
    # ARFE hybrid's config has no data section
    data = cfg.get('data', {})
    for split in ([data['train']] if isinstance(data.get('train'), dict)
                  else data.get('train', [])) + [data.get('test')]:
        if split is not None:
            Compose(split['pipeline'])
    assert model.with_mask == ('mask' in path)
    assert ('data' in cfg) == (path != 'arfe/faster_fsaf_r50_1x_coco.py')
    if 'cascade' in path:
        assert model.num_step_extractions == 6 and not model.serves_masks
    if path.startswith('rpn/'):
        assert type(model).__name__ == 'RPN' and model.num_extractions == 0
    if 'fsaf_' in path and not path.startswith('fsaf/'):
        # the hybrids mount FSAFHead as the RoI head's bbox head
        assert type(model.roi_head.bbox_head).__name__ == 'FSAFHead'
