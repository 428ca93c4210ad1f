"""VisDrone and the dataset wrappers in the port against the JAX package on
the CPU: ``VisdroneDataset`` (12 classes), ``ConcatDataset``,
``RepeatDataset`` and ``ClassBalancedDataset`` (their indices, ``flag``s and
repeat factors exactly the JAX wrappers'), ``build_dataset``'s list and
wrapper forms, and the VisDrone configs' list-valued ``data.train``, on
synthetic VisDrone-style sets written by ``data.synthetic``."""
import os

import numpy as np
import pytest
from test_torch_threads import one_torch_thread  # noqa: F401

from arfe_tpu.data import build_dataset as j_build_dataset
from arfe_tpu_torch.config import Config
from arfe_tpu_torch.data import (ClassBalancedDataset, ConcatDataset,
                                 RepeatDataset, VisdroneDataset,
                                 build_dataset, synthetic)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VISDRONE_CFG = os.path.join(REPO, 'configs', 'mytrain',
                            'faster_rcnn_r50_fpn_multicls_1x_visdrone.py')
CATEGORIES = [dict(id=i + 1, name=n)
              for i, n in enumerate(VisdroneDataset.CLASSES)]
# two sets of mixed aspect ratios; the second's boxes mostly of few
# classes, so that the class-balanced repeat factors differ
SETS = {'train': ([(96, 128), (128, 96), (96, 160), (120, 120), (128, 96)],
                  0, (2, 4)),
        'val': ([(128, 96), (96, 128), (96, 128)], 1, (1, 2))}


@pytest.fixture(scope='module')
def sets(tmp_path_factory):
    """The two sets' dataset configs (the VisDrone config's train
    pipeline), with their annotation files written."""
    root = tmp_path_factory.mktemp('visdrone')
    pipeline = Config.fromfile(VISDRONE_CFG).todict()['data']['train'][0][
        'pipeline']
    cfgs = {}
    for name, (sizes, seed, per_image) in SETS.items():
        cats = CATEGORIES if name == 'train' else CATEGORIES[1:4]
        synthetic.write_box_set(str(root / name), sizes, per_image, seed,
                                cats)
        synthetic.write_annotations(
            str(root / name / 'ann.json'),
            *_annotations(str(root / name / 'ann.json')), CATEGORIES)
        cfgs[name] = dict(type='VisdroneDataset',
                          ann_file=str(root / name / 'ann.json'),
                          img_prefix=str(root / name / 'imgs') + '/',
                          pipeline=pipeline)
    return cfgs


def _annotations(path):
    """The images and annotations of a written set, to rewrite it with all
    twelve VisDrone categories."""
    import json
    with open(path) as f:
        d = json.load(f)
    return d['images'], d['annotations']


def _same(ours, theirs):
    """The same length, ``flag`` and, index by index, the same image and
    annotations."""
    assert len(ours) == len(theirs)
    np.testing.assert_array_equal(ours.flag, theirs.flag)
    assert ours.flag.dtype == theirs.flag.dtype
    for i in range(len(ours)):
        a, b = ours.get_ann_info(i), theirs.get_ann_info(i)
        np.testing.assert_array_equal(a['bboxes'], b['bboxes'])
        np.testing.assert_array_equal(a['labels'], b['labels'])


def test_visdrone_dataset_matches_jax(sets):
    """Twelve classes, the first the ignored regions; the same images,
    labels and aspect-ratio flags as the JAX dataset."""
    ours = build_dataset(sets['train'])
    theirs = j_build_dataset(sets['train'])
    assert isinstance(ours, VisdroneDataset)
    assert len(ours.CLASSES) == 12 and ours.CLASSES[0] == 'ignored-regions'
    assert ours.CLASSES == tuple(theirs.CLASSES)
    _same(ours, theirs)
    assert set(ours.flag.tolist()) == {0, 1}


def test_concat_dataset_matches_jax(sets):
    """A list of configs is their ``ConcatDataset``: the cumulative sizes,
    each index's dataset and sample, and the concatenated flags."""
    cfg = [sets['train'], sets['val']]
    ours, theirs = build_dataset(cfg), j_build_dataset(cfg)
    assert isinstance(ours, ConcatDataset)
    assert ours.cumulative_sizes == theirs.cumulative_sizes == [5, 8]
    _same(ours, theirs)
    sample = ours[6]
    assert sample['img_metas']['ori_shape'][:2] == SETS['val'][0][1]


@pytest.mark.parametrize('times', [1, 3])
def test_repeat_dataset_matches_jax(sets, times):
    cfg = dict(type='RepeatDataset', times=times, dataset=sets['val'])
    ours, theirs = build_dataset(cfg), j_build_dataset(cfg)
    assert isinstance(ours, RepeatDataset)
    _same(ours, theirs)


@pytest.mark.parametrize('thr', [0.1, 0.5, 1.0])
def test_class_balanced_dataset_matches_jax(sets, thr):
    """The repeat factors of each image and the repeated indices (and so
    the flags) exactly the JAX wrapper's, over the concatenation of both
    sets."""
    cfg = dict(type='ClassBalancedDataset', oversample_thr=thr,
               dataset=[sets['train'], sets['val']])
    ours, theirs = build_dataset(cfg), j_build_dataset(cfg)
    assert isinstance(ours, ClassBalancedDataset)
    assert ours.repeat_indices == theirs.repeat_indices
    want = theirs._get_repeat_factors(theirs.dataset, thr)
    assert ours.repeat_factors == want
    _same(ours, theirs)
    if thr == 1.0:
        assert len(ours) > len(ours.dataset)


def test_visdrone_config_trains_on_a_concat_dataset(sets):
    """The VisDrone config's ``data.train``, a list of two sets, builds a
    ``ConcatDataset`` of two ``VisdroneDataset``s (its paths put on the
    synthetic sets), whose loader groups both sets' images by aspect
    ratio."""
    from arfe_tpu_torch.data import build_dataloader
    cfg = Config.fromfile(VISDRONE_CFG).todict()['data']['train']
    assert isinstance(cfg, list) and len(cfg) == 2
    for c, name in zip(cfg, ('train', 'val')):
        c.update(ann_file=sets[name]['ann_file'],
                 img_prefix=sets[name]['img_prefix'])
    dataset = build_dataset(cfg)
    assert isinstance(dataset, ConcatDataset)
    assert [type(d).__name__ for d in dataset.datasets] == [
        'VisdroneDataset'] * 2
    loader = build_dataloader(dataset, 2, 0, seed=0)
    batches = list(loader.batch_sampler.sampler)
    assert sorted(i for b in batches for i in b) == list(range(8))
    for b in batches:
        assert len(set(dataset.flag[b].tolist())) == 1
