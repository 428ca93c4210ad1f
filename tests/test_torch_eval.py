"""The port's evaluation path against the JAX package on the CPU: the COCO API
and ``COCOEvaluator`` on synthetic ground truth, and the whole stack
(``CocoDataset`` of PNG files -> test pipeline -> loader ->
``single_device_test`` -> ``evaluate``) on the tiny AR-RFF detector with the
same weights on both sides; ``inference_detector``; and the ``test`` CLI.

Every test image resizes and pads to 192 x 256, so the JAX side compiles its
detector once.
"""
import os
import subprocess
import sys

import cv2
import jax
import numpy as np
import pytest
from test_torch_arrff import CONFIGS, tiny
from test_torch_detector import _iou, _perturb
from test_torch_threads import one_torch_thread  # noqa: F401

from arfe_tpu.apis.test import single_device_test as j_single_device_test
from arfe_tpu.config import Config as JConfig
from arfe_tpu.convert import state_dict_to_params
from arfe_tpu.core.evaluation import COCOEvaluator as JCOCOEvaluator
from arfe_tpu.data import COCO as JCOCO
from arfe_tpu.data import build_dataloader as j_build_dataloader
from arfe_tpu.data import build_dataset as j_build_dataset
from arfe_tpu.models import build_detector as j_build_detector
from arfe_tpu.utils import save_checkpoint
from arfe_tpu_torch.apis import (inference_detector, init_detector,
                                 single_device_test)
from arfe_tpu_torch.config import Config
from arfe_tpu_torch.convert import params_to_state_dict
from arfe_tpu_torch.core.evaluation import COCOEvaluator
from arfe_tpu_torch.data import (COCO, CocoDataset, build_dataloader,
                                 build_dataset, synthetic)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CFG = os.path.join(REPO, 'arfe_tpu_torch', 'configs',
                        'faster_rcnn_r50_arfpn_arrff_1x_coco.py')
TEST_SCALE = (256, 192)
# (h, w): each resizes to at most 256 x 192 and pads to 192 x 256
SIZES = [(240, 320), (225, 300), (230, 310), (192, 256)]
STATS = ('bbox_mAP', 'bbox_AP50', 'bbox_AP75', 'bbox_APs', 'bbox_APm',
         'bbox_APl')
CATEGORIES = synthetic.CATEGORIES


# --------------------------------------------------------------------------
# the COCO API and the evaluator
# --------------------------------------------------------------------------

def _synthetic_coco(seed):
    """Ground truth of 6 images (one without annotations) over 5 classes
    with boxes of every area range, crowd and ignored boxes, and detections:
    jittered copies of most boxes, misses and false positives."""
    rng = np.random.RandomState(seed)
    images = [dict(id=i + 1, width=640, height=480) for i in range(6)]
    anns, dets = [], []
    for img in images[:5]:
        for _ in range(rng.randint(3, 9)):
            side = float(np.exp(rng.uniform(np.log(8), np.log(300))))
            w, h = side * rng.uniform(0.6, 1.4), side * rng.uniform(0.6, 1.4)
            x, y = rng.uniform(0, 640 - w), rng.uniform(0, 480 - h)
            cat = int(rng.randint(1, 6))
            anns.append(dict(id=len(anns) + 1, image_id=img['id'],
                             category_id=cat, bbox=[x, y, w, h], area=w * h,
                             iscrowd=int(rng.rand() < 0.1),
                             ignore=int(rng.rand() < 0.05)))
            if rng.rand() < 0.8:
                j = rng.uniform(-0.15, 0.15, 4) * side
                dets.append(dict(image_id=img['id'], category_id=cat,
                                 bbox=[x + j[0], y + j[1], w + j[2],
                                       h + j[3]], score=float(rng.rand())))
        for _ in range(rng.randint(0, 4)):
            dets.append(dict(image_id=img['id'],
                             category_id=int(rng.randint(1, 6)),
                             bbox=[float(v) for v in rng.uniform(0, 200, 4)],
                             score=float(rng.rand())))
    return dict(images=images, annotations=anns,
                categories=CATEGORIES[:5]), dets


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_coco_evaluator_matches_jax(seed):
    """The same precision and recall tables and the same twelve stats."""
    gt, dets = _synthetic_coco(seed)
    port, ref = COCO.from_dict(gt), JCOCO.from_dict(gt)
    assert port.getImgIds() == ref.getImgIds()
    assert port.getAnnIds(imgIds=[1, 2], catIds=[1, 3], iscrowd=0) == \
        ref.getAnnIds(imgIds=[1, 2], catIds=[1, 3], iscrowd=0)
    assert port.getCatIds(catNms=['bicycle', 'car']) == [2, 3]
    got = COCOEvaluator(port).evaluate(port.loadRes(dets))
    want = JCOCOEvaluator(ref).evaluate(ref.loadRes(dets))
    np.testing.assert_array_equal(got['precision'], want['precision'])
    np.testing.assert_array_equal(got['recall'], want['recall'])
    assert got['stats'] == want['stats']
    assert 0 < got['stats']['AP'] < 1
    assert all(got['stats'][k] > -1 for k in ('APs', 'APm', 'APl'))


# --------------------------------------------------------------------------
# the whole stack on the tiny AR-RFF detector
# --------------------------------------------------------------------------

def _data_cfg(root):
    return dict(type='CocoDataset', ann_file=os.path.join(root, 'ann.json'),
                img_prefix=os.path.join(root, 'imgs'),
                pipeline=_test_pipeline())


def _test_pipeline():
    pipeline = Config.fromfile(PORT_CFG).todict()['data']['test']['pipeline']
    pipeline[1]['img_scale'] = TEST_SCALE
    return pipeline


@pytest.fixture(scope='module')
def stack(tmp_path_factory):
    """Both sides' results and stats on four PNGs, the same weights (the
    port's seeded random weights, perturbed as the detector tests do)."""
    root = str(tmp_path_factory.mktemp('coco'))
    images = synthetic.write_images(root, SIZES, seed=11)
    ann_file = os.path.join(root, 'ann.json')
    synthetic.write_annotations(ann_file, images)
    cfg = tiny(Config.fromfile(PORT_CFG).todict())
    cfg['data']['test'] = _data_cfg(root)
    cfg['data']['workers_per_gpu'] = 0
    model = init_detector(Config(cfg), device='cpu')
    params = _perturb(state_dict_to_params(model.state_dict()),
                      np.random.RandomState(1))
    model.load_state_dict(params_to_state_dict(params), strict=True)

    dataset = build_dataset(cfg['data']['test'], dict(test_mode=True))
    results = single_device_test(model, build_dataloader(dataset, 1, 0),
                                 show_progress=False)
    synthetic.write_annotations(
        ann_file, images, synthetic.seed_ground_truth(images, results))
    dataset = build_dataset(cfg['data']['test'], dict(test_mode=True))
    stats = dataset.evaluate(results, metric='bbox')

    jcfg = tiny(JConfig.fromfile(CONFIGS['arrff']).todict())
    jmodel = j_build_detector(jcfg['model'], test_cfg=jcfg['test_cfg'])
    jdataset = j_build_dataset(_data_cfg(root), dict(test_mode=True))
    jloader = j_build_dataloader(jdataset, samples_per_gpu=1,
                                 workers_per_gpu=0, shuffle=False,
                                 static_shapes=None, test_mode=True)
    jresults = j_single_device_test(
        jmodel, jax.tree_util.tree_map(jax.numpy.asarray, params), jloader,
        show_progress=False)
    return dict(root=root, model=model, params=params, cfg=cfg,
                results=results, stats=stats, jresults=jresults,
                jstats=jdataset.evaluate(jresults, metric='bbox'))


def test_stack_stats_match_jax(stack):
    """The six bbox stats within 1e-3, AP inside (0.05, 0.999)."""
    got, want = stack['stats'], stack['jstats']
    assert sorted(got) == sorted(want) == sorted(STATS)
    assert 0.05 < want['bbox_mAP'] < 0.999, want
    for k in STATS:
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])


def _flat(per_class):
    return [(box[4], c, box[:4]) for c, boxes in enumerate(per_class)
            for box in boxes]


def _unmatched(ref, got):
    """The rule of tests/test_e2e_parity_arfe.py:345-366: each reference
    detection is matched by an unused one of the same label, IoU > 0.7 and
    score within 1e-2."""
    used, missing = set(), []
    for sc, lab, box in ref:
        if not any(j not in used and glab == lab and _iou(box, gbox) > 0.7
                   and abs(gsc - sc) < 1e-2 and not used.add(j)
                   for j, (gsc, glab, gbox) in enumerate(got)):
            missing.append((round(float(sc), 3), lab))
    return missing


def test_stack_detections_match_jax(stack):
    """Per image, in the original image's coordinates."""
    for i, (got, want) in enumerate(zip(stack['results'],
                                        stack['jresults'])):
        assert len(got) == len(want) == 80
        ref, mine = _flat(want), _flat(got)
        assert len(ref) >= 5 and len(mine) == len(ref)
        assert not _unmatched(ref, mine), (i, _unmatched(ref, mine)[:5])


def test_inference_detector_matches_jax(stack):
    """``inference_detector`` on a path and on the BGR array gives the
    loader path's detections, which match the JAX detector's
    ``simple_test`` of the same pad-32 image (its loader's, with
    ``static_shapes=None``)."""
    model = stack['model']
    path = os.path.join(stack['root'], 'imgs', '1.png')
    got = inference_detector(model, path)
    for a, b in zip(got, stack['results'][1]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(inference_detector(model, cv2.imread(path)), got):
        np.testing.assert_array_equal(a, b)
    assert not _unmatched(_flat(stack['jresults'][1]), _flat(got))
    assert list(model.CLASSES) == [c.replace(' ', '_')
                                   for c in CocoDataset.CLASSES]


def _write_config(path, cfg):
    """A config file of the dict's top-level keys."""
    with open(path, 'w') as f:
        for key, value in cfg.items():
            f.write(f'{key} = {value!r}\n')


def test_test_cli_prints_the_stats(stack, tmp_path):
    """``python -m arfe_tpu_torch.tools.test CONFIG CKPT --device cpu --eval
    bbox`` with a JAX-written ``.pkl`` and one loader worker prints the
    stack's six stats."""
    cfg = dict(stack['cfg'])
    cfg['data'] = dict(cfg['data'], workers_per_gpu=1)
    config = str(tmp_path / 'cfg.py')
    _write_config(config, cfg)
    ckpt = str(tmp_path / 'epoch_1.pkl')
    save_checkpoint(ckpt, stack['params'], meta=dict(epoch=1))
    proc = subprocess.run(
        [sys.executable, '-m', 'arfe_tpu_torch.tools.test', config, ckpt,
         '--device', 'cpu', '--eval', 'bbox'],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    printed = dict(line.split(': ') for line in proc.stdout.splitlines()
                   if line.startswith('bbox_'))
    assert sorted(printed) == sorted(STATS)
    for k in STATS:
        assert float(printed[k]) == pytest.approx(stack['stats'][k],
                                                  abs=1e-4)
