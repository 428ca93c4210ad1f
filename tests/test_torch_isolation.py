"""The port stands alone: importing any of its modules (the data and
evaluation path, the training run, the masks of Mask R-CNN, Cascade R-CNN's
and RetinaNet's heads, ResNeXt, the C4 shared head, the RPN detector, FSAF,
the IoU losses, the experimental necks, AttRoIs, the dataset wrappers,
proposal recall, and the ``test``, ``train``, ``e2e_smoke`` and
``config_census`` tools among them), or ``chip_smoke``,
loads no JAX, no optax and nothing of the JAX package; its entry point
defaults to the card."""
import os
import subprocess
import sys

import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = '''
import importlib, pkgutil, sys
import arfe_tpu_torch, chip_smoke
for m in pkgutil.walk_packages(arfe_tpu_torch.__path__, 'arfe_tpu_torch.'):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'arfe_tpu'))
missing = [m for m in ('arfe_tpu_torch.train.optimizer',
                       'arfe_tpu_torch.train.train_step',
                       'arfe_tpu_torch.train.bench',
                       'arfe_tpu_torch.models.losses.cross_entropy_loss',
                       'arfe_tpu_torch.core.bbox.samplers',
                       'arfe_tpu_torch.data.image_io',
                       'arfe_tpu_torch.data.pipelines',
                       'arfe_tpu_torch.data.custom',
                       'arfe_tpu_torch.data.coco_api',
                       'arfe_tpu_torch.data.coco',
                       'arfe_tpu_torch.data.builder',
                       'arfe_tpu_torch.core.evaluation.coco_eval',
                       'arfe_tpu_torch.core.evaluation.class_names',
                       'arfe_tpu_torch.utils.checkpoint',
                       'arfe_tpu_torch.apis.test',
                       'arfe_tpu_torch.tools.test',
                       'arfe_tpu_torch.apis.train',
                       'arfe_tpu_torch.tools.train',
                       'arfe_tpu_torch.tools.e2e_smoke',
                       'arfe_tpu_torch.utils.logger',
                       'arfe_tpu_torch.utils.collect_env',
                       'arfe_tpu_torch.utils.pretrained',
                       'arfe_tpu_torch.core.mask.structures',
                       'arfe_tpu_torch.core.mask.rle',
                       'arfe_tpu_torch.core.mask.mask_target',
                       'arfe_tpu_torch.models.roi_heads.mask_heads.'
                       'fcn_mask_head',
                       'arfe_tpu_torch.data.synthetic',
                       'arfe_tpu_torch.models.roi_heads.cascade_roi_head',
                       'arfe_tpu_torch.models.dense_heads.retina_head',
                       'arfe_tpu_torch.models.detectors.single_stage',
                       'arfe_tpu_torch.models.losses.focal_loss',
                       'arfe_tpu_torch.models.necks.fpn',
                       'arfe_tpu_torch.tools.step_conditioning',
                       'arfe_tpu_torch.models.backbones.resnext',
                       'arfe_tpu_torch.models.roi_heads.shared_heads.'
                       'res_layer',
                       'arfe_tpu_torch.models.detectors.rpn',
                       'arfe_tpu_torch.models.dense_heads.fsaf_head',
                       'arfe_tpu_torch.models.losses.iou_loss',
                       'arfe_tpu_torch.models.necks.experimental_fpns',
                       'arfe_tpu_torch.models.roi_heads.bbox_heads.'
                       'attrois_bbox_head',
                       'arfe_tpu_torch.data.dataset_wrappers',
                       'arfe_tpu_torch.core.evaluation.recall',
                       'arfe_tpu_torch.tools.config_census')
           if m not in sys.modules]
print('modules:', len(sys.modules), 'forbidden:', bad, 'missing:', missing)
sys.exit(1 if bad or missing else 0)
'''


def test_import_loads_no_jax():
    proc = subprocess.run([sys.executable, '-c', _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_init_detector_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    from arfe_tpu_torch.apis import init_detector
    with pytest.raises(RuntimeError, match='no CUDA device'):
        init_detector(os.path.join(REPO, 'configs', '_base_', 'models',
                                   'faster_rcnn_r50_arfpn.py'))
