"""The slice as a whole: the tiny flagship Faster R-CNN + AR-FPN (R18, 64
channels, 64 proposals, as ``__graft_entry__._build_flagship(tiny=True)``)
in the port against the JAX package on the CPU, with the same weights
(JAX params -> numpy -> ``params_to_state_dict``) and images."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import FLAGSHIP_CFG, _build_flagship
from arfe_tpu.core.bbox.transforms import bbox2result as j_bbox2result
from arfe_tpu_torch.apis import init_detector
from arfe_tpu_torch.config import Config
from arfe_tpu_torch.convert import params_to_state_dict
from arfe_tpu_torch.core.bbox import bbox2result
from arfe_tpu_torch.models import build_detector

SHAPES = np.array([[128., 150.], [120., 160.]], np.float32)
SCALES = np.array([[1.5] * 4, [2.0] * 4], np.float32)
# XLA compiles the tiny detector's programs faster at its lowest
# optimisation level; it runs them a little slower
FAST_COMPILE = {'xla_backend_optimization_level': 0,
                'xla_llvm_disable_expensive_passes': True}


def tiny_cfg():
    """The port's config dict of ``_build_flagship(tiny=True)``, with its
    TPU-only ``stem_space_to_depth`` key, which the port ignores."""
    cfg = Config.fromfile(FLAGSHIP_CFG).todict()
    mc = cfg['model']
    mc['backbone'].update(depth=18, stem_space_to_depth=True)
    mc['neck'][0].update(in_channels=[64, 128, 256, 512], out_channels=64)
    mc['neck'][1]['in_channels'] = 64
    mc['rpn_head'].update(in_channels=64, feat_channels=64)
    mc['roi_head']['bbox_roi_extractor']['out_channels'] = 64
    mc['roi_head']['bbox_head'].update(in_channels=64, fc_out_channels=128)
    cfg['test_cfg']['rpn'].update(nms_pre=100, nms_post=64, max_num=64)
    return cfg


def _perturb(params, rng):
    """Non-trivial BN statistics, a nonzero NonLocal ``conv_out`` (zero at
    init, which would hide the attention), and spread-out classifiers."""
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
    co = params['neck']['1']['refine']['conv_out']['conv']
    co['weight'] = rng.normal(0, 0.02, co['weight'].shape).astype(np.float32)
    params['rpn_head']['rpn_cls']['weight'] *= 8
    params['roi_head']['bbox_head']['fc_cls']['weight'] *= 30
    return params


@pytest.fixture(scope='module')
def runs():
    jm = _build_flagship(tiny=True)
    params = jax.tree_util.tree_map(
        np.array, jax.jit(jm.init, compiler_options=FAST_COMPILE)(
            jax.random.PRNGKey(0)))
    rng = np.random.RandomState(0)
    params = _perturb(params, rng)
    img = (rng.randn(2, 128, 160, 3) * 0.2).astype(np.float32)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jfeat = jax.jit(jm.extract_feat, compiler_options=FAST_COMPILE)(
        jp, jnp.asarray(img))
    jprops = jax.jit(jm.rpn_head.get_proposals,
                     compiler_options=FAST_COMPILE)(
        jp['rpn_head'], jfeat, jnp.asarray(SHAPES))
    jdets = jax.jit(lambda p, f, pr, pv, s, sf: jm.roi_head.simple_test(
        p, f, pr, pv, s, sf, rescale=True), compiler_options=FAST_COMPILE)(
            jp['roi_head'], jfeat, *jprops, jnp.asarray(SHAPES),
            jnp.asarray(SCALES))

    cfg = tiny_cfg()
    tm = build_detector(cfg['model'], train_cfg=cfg['train_cfg'],
                        test_cfg=cfg['test_cfg'])
    state = params_to_state_dict(params)
    tm.load_state_dict(state, strict=True)
    tm.eval()
    timg, tshapes, tscales = (torch.from_numpy(x) for x in
                              (img, SHAPES, SCALES))
    with torch.no_grad():
        tfeat = tm.extract_feat(timg)
        tprops = tm.rpn_head.get_proposals(tfeat, tshapes)
    tdets = tm.simple_test(timg, tshapes, tscales, rescale=True)
    to_np = lambda xs: [np.asarray(x) for x in xs]  # noqa: E731
    return dict(
        jax=dict(feat=to_np(jfeat), props=to_np(jprops), dets=to_np(jdets)),
        torch=dict(feat=[f.permute(0, 2, 3, 1).numpy() for f in tfeat],
                   props=to_np(tprops), dets=to_np(tdets)),
        state=state, cfg=cfg, inputs=(timg, tshapes, tscales))


@pytest.mark.parametrize('level', range(5))
def test_extract_feat_matches_jax(runs, level):
    want, got = runs['jax']['feat'][level], runs['torch']['feat'][level]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_proposals_match_jax(runs):
    (jp, jv), (tp, tv) = runs['jax']['props'], runs['torch']['props']
    np.testing.assert_array_equal(tv, jv)
    assert tv.sum() == 2 * 64
    # the same boxes in the same order; coordinates to f32 rounding
    np.testing.assert_allclose(tp, jp, atol=1e-4)


def _iou(a, b):
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(x2 - x1, 0) * max(y2 - y1, 0)
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return inter / max(union, 1e-10)


def test_detections_match_jax(runs):
    """The matching rule of tests/test_e2e_parity_arfe.py:345-366, with the
    JAX detections as the reference: every one is matched by an unused port
    detection of the same label, IoU > 0.7 and score within 1e-2."""
    (jd, jl, jv), (td, tl_, tv) = runs['jax']['dets'], runs['torch']['dets']
    assert tv.shape == jv.shape and td.shape == (2, 100, 5)
    assert tl_.dtype == np.int32
    for i in range(2):
        ref = [(jd[i, k, 4], jl[i, k], jd[i, k, :4])
               for k in range(len(jd[i])) if jv[i, k]]
        got = [(td[i, k, 4], tl_[i, k], td[i, k, :4])
               for k in range(len(td[i])) if tv[i, k]]
        assert len(ref) >= 5 and len(got) == len(ref)
        used, unmatched = set(), []
        for sc, lab, box in ref:
            if not any(j not in used and glab == lab and _iou(box, gbox) > 0.7
                       and abs(gsc - sc) < 1e-2 and not used.add(j)
                       for j, (gsc, glab, gbox) in enumerate(got)):
                unmatched.append((round(float(sc), 3), int(lab)))
        assert not unmatched, f'image {i}: unmatched {unmatched[:5]}'
        # padding rows of the fixed-capacity output
        assert (td[i][~tv[i]] == [0, 0, 0, 0, -1]).all()


def test_bbox2result_matches_jax(runs):
    (td, tl_, _), (jd, jl, _) = runs['torch']['dets'], runs['jax']['dets']
    got, want = bbox2result(td[0], tl_[0], 80), j_bbox2result(jd[0], jl[0], 80)
    assert len(got) == len(want) == 80
    assert [len(g) for g in got] == [len(w) for w in want]


def test_init_detector_loads_mmdet_checkpoint(runs, tmp_path):
    """An mmdet-style .pth ('module.' prefixes, BN num_batches_tracked,
    meta) loads with strict=True and serves the same detections."""
    state = {'module.' + k: v for k, v in runs['state'].items()}
    state.update({'module.backbone.bn1.num_batches_tracked':
                  torch.tensor(7)})
    path = tmp_path / 'ckpt.pth'
    torch.save({'state_dict': state, 'meta': {'epoch': 1}}, path)
    model = init_detector(Config(runs['cfg']), str(path), device='cpu')
    dets = model.simple_test(*runs['inputs'], rescale=True)
    np.testing.assert_array_equal(dets[0].numpy(), runs['torch']['dets'][0])


def test_init_detector_random_weights_are_seeded():
    cfg = Config(tiny_cfg())
    a = init_detector(cfg, device='cpu')
    b = init_detector(cfg, device='cpu')
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    conv_out = a.neck[1].refine.conv_out.conv.weight
    assert not conv_out.any()        # zero-initialised residual, as in JAX
