"""The port's test-time data path against OpenCV and the JAX package on the
CPU: the PNG reader against ``cv2.imread``, ``imresize`` against
``cv2.resize(INTER_LINEAR)``, the test pipeline of the AR-RFF port config
against the JAX ``Compose`` of the same config, the loader's collate against
``collate_detection(..., static_shapes=None)``, and the JAX package's native
checkpoint read without JAX."""
import os
import pickle
import subprocess
import sys

import cv2
import jax
import numpy as np
import optax
import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401

from arfe_tpu.config import Config as JConfig
from arfe_tpu.data.builder import collate_detection
from arfe_tpu.data.pipelines import Compose as JCompose
from arfe_tpu.utils import save_checkpoint
from arfe_tpu_torch.config import Config
from arfe_tpu_torch.convert import params_to_state_dict
from arfe_tpu_torch.data import Compose, collate_test
from arfe_tpu_torch.data.image_io import imread, imresize, imwrite_png
from arfe_tpu_torch.utils import load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CFG = os.path.join(REPO, 'arfe_tpu_torch', 'configs',
                        'faster_rcnn_r50_arfpn_arrff_1x_coco.py')
FILTERS = ('NONE', 'SUB', 'UP', 'AVG', 'PAETH')


# --------------------------------------------------------------------------
# reading and writing PNG
# --------------------------------------------------------------------------

def _pattern(shape, seed):
    """Noise on a ramp: every row filter has work to do."""
    rng = np.random.RandomState(seed)
    ramp = np.add.outer(np.arange(shape[0]), 3 * np.arange(shape[1]))
    ramp = ramp.reshape(shape[:2] + (1,) * (len(shape) - 2))
    return ((ramp + rng.randint(0, 40, shape)) % 256).astype(np.uint8)


@pytest.mark.parametrize('channels', [None, 3, 4])
@pytest.mark.parametrize('filt', FILTERS)
def test_png_reader_matches_cv2(tmp_path, filt, channels):
    """Grey, BGR and BGRA images that OpenCV writes with each row filter
    read back as ``cv2.imread(IMREAD_COLOR)`` reads them, byte for byte."""
    shape = (13, 17) if channels is None else (13, 17, channels)
    path = str(tmp_path / 'img.png')
    assert cv2.imwrite(path, _pattern(shape, len(filt)), [
        cv2.IMWRITE_PNG_FILTER, getattr(cv2, f'IMWRITE_PNG_FILTER_{filt}')])
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    got = imread(path)
    assert got.dtype == np.uint8 and got.shape == want.shape == (13, 17, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('shape', [(9, 11), (9, 11, 3), (9, 11, 4)])
def test_png_writer_round_trips_through_cv2(tmp_path, shape):
    img = _pattern(shape, 3)
    path = str(tmp_path / 'img.png')
    imwrite_png(path, img)
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(imread(path), want)
    bgr = img[..., :3] if img.ndim == 3 else np.repeat(img[..., None], 3, 2)
    np.testing.assert_array_equal(want, bgr)


def test_png_reader_names_what_it_does_not_read(tmp_path):
    """16-bit (OpenCV writes it) and interlaced PNGs raise a ValueError
    naming the file."""
    deep = str(tmp_path / 'deep.png')
    cv2.imwrite(deep, np.zeros((4, 5, 3), np.uint16))
    with pytest.raises(ValueError, match='deep.png.*bit depth 16'):
        imread(deep)
    interlaced = tmp_path / 'interlaced.png'
    imwrite_png(str(interlaced), np.zeros((4, 5, 3), np.uint8))
    data = bytearray(interlaced.read_bytes())
    data[28] = 1                 # IHDR's interlace byte: Adam7
    interlaced.write_bytes(bytes(data))
    with pytest.raises(ValueError, match='interlaced.png.*interlace 1'):
        imread(str(interlaced))
    with pytest.raises(FileNotFoundError):
        imread(str(tmp_path / 'missing.png'))


# --------------------------------------------------------------------------
# resizing
# --------------------------------------------------------------------------

RESIZES = [
    ((480, 640), (800, 1067)),    # COCO landscape to the test scale
    ((640, 480), (1067, 800)),    # portrait
    ((427, 640), (800, 1199)),
    ((90, 100), (37, 41)),        # downscale
    ((48, 64), (24, 32)),         # exact halving: OpenCV's area path
    ((37, 53), (91, 17)),         # odd sizes, up in one axis, down in one
    ((1, 30), (1, 7)),            # 1-pixel edges
    ((30, 1), (7, 1)),
    ((7, 5), (1, 1)),
    ((1, 1), (5, 7)),
]


@pytest.mark.parametrize('channels', [None, 3])
@pytest.mark.parametrize('src,dst', RESIZES)
def test_imresize_matches_cv2(src, dst, channels):
    """uint8: OpenCV's bytes exactly. float32: within 1e-4 of the value
    range (OpenCV's float path rounds its weights differently, a few 1e-5
    of the range)."""
    shape = src if channels is None else src + (channels,)
    img = np.random.RandomState(sum(src + dst)).randint(0, 256, shape) \
        .astype(np.uint8)
    size = (dst[1], dst[0])
    want = cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)
    got = imresize(img, size)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    f = img.astype(np.float32)
    want = cv2.resize(f, size, interpolation=cv2.INTER_LINEAR)
    got = imresize(f, size)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * 255)


# --------------------------------------------------------------------------
# the test pipeline and the collate
# --------------------------------------------------------------------------

COCO_SIZES = [(480, 640), (640, 480), (427, 640), (375, 500)]


@pytest.fixture(scope='module')
def images(tmp_path_factory):
    """Smooth PNGs at COCO's shapes, written by OpenCV."""
    root = tmp_path_factory.mktemp('imgs')
    rng = np.random.RandomState(5)
    names = []
    for i, (h, w) in enumerate(COCO_SIZES):
        small = rng.randint(0, 256, (h // 20, w // 20, 3)).astype(np.uint8)
        cv2.imwrite(str(root / f'{i}.png'),
                    cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR))
        names.append(f'{i}.png')
    return str(root), names


def _pipelines():
    """The port's and the JAX package's test pipeline of the port config
    (coco_detection's: 1333 x 800, Normalize, Pad to 32)."""
    port = Config.fromfile(PORT_CFG).todict()['data']['test']['pipeline']
    jax_cfg = JConfig.fromfile(PORT_CFG).todict()['data']['test']['pipeline']
    assert port == jax_cfg
    return Compose(port), JCompose(jax_cfg)


def _run(pipeline, root, name):
    return pipeline(dict(img_info=dict(filename=name), img_prefix=root,
                         bbox_fields=[], mask_fields=[]))


def test_test_pipeline_matches_jax(images):
    """Every image bit for bit and every meta key equal, on four PNGs."""
    root, names = images
    port, jax_pipe = _pipelines()
    for name in names:
        got, want = _run(port, root, name), _run(jax_pipe, root, name)
        assert sorted(got) == sorted(want) == ['img', 'img_metas']
        assert len(got['img']) == len(want['img']) == 1
        np.testing.assert_array_equal(got['img'][0], want['img'][0])
        assert got['img'][0].dtype == want['img'][0].dtype == np.float32
        gm, wm = got['img_metas'][0], want['img_metas'][0]
        assert sorted(gm) == sorted(wm)
        for key in wm:
            if key == 'img_norm_cfg':
                for k in wm[key]:
                    np.testing.assert_array_equal(gm[key][k], wm[key][k])
            else:
                np.testing.assert_array_equal(gm[key], wm[key], err_msg=key)
        h, w = gm['pad_shape'][:2]
        assert h % 32 == 0 and w % 32 == 0 and max(h, w) <= 1344


def _odd_samples():
    """Unpadded images of odd sizes, one without a scale factor."""
    rng = np.random.RandomState(2)
    samples = []
    for h, w, sf in ((70, 50, [1.5, 1.25, 1.5, 1.25]), (33, 97, None)):
        meta = dict(img_shape=(h, w, 3), scale_factor=None if sf is None
                    else np.array(sf, np.float32))
        samples.append(dict(img=[rng.randn(h, w, 3).astype(np.float32)],
                            img_metas=[meta]))
    return samples


@pytest.mark.parametrize('kind', ['pipeline', 'odd'])
def test_collate_matches_jax(images, kind):
    """At bs2: the batch padded to the multiple of 32 above the largest
    image, as ``collate_detection`` with ``static_shapes=None``; a landscape
    and a portrait image from the pipeline, and two odd-sized arrays."""
    if kind == 'pipeline':
        root, names = images
        port, _ = _pipelines()
        samples = [_run(port, root, name) for name in names[:2]]
        shape = (2, 1088, 1088, 3)
    else:
        samples, shape = _odd_samples(), (2, 96, 128, 3)
    got = collate_test(samples)
    want = collate_detection(samples, static_shapes=None, test_mode=True)
    assert got['img'].dtype == torch.float32
    assert tuple(got['img'].shape) == want['img'].shape == shape
    for key in ('img', 'img_shape', 'scale_factor'):
        np.testing.assert_array_equal(got[key].numpy(), want[key],
                                      err_msg=key)
    assert got['img_metas'] == [s['img_metas'][0] for s in samples]


# --------------------------------------------------------------------------
# the JAX package's native checkpoint
# --------------------------------------------------------------------------

def _params():
    rng = np.random.RandomState(7)
    return {
        'backbone': {'conv1': {'weight': rng.randn(3, 3, 2, 4)},
                     'bn1': {'weight': rng.randn(4),
                             'running_var': rng.rand(4)}},
        'roi_head': {'bbox_head': {'fc_cls': {
            'weight': rng.randn(5, 6), 'bias': rng.randn(5)}}},
    }


@pytest.fixture(scope='module')
def checkpoint(tmp_path_factory):
    """A ``.pkl`` as the JAX trainer writes it: parameters, an optax SGD
    state with momentum and ``meta``."""
    params = _params()
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, params)
    opt_state = optax.sgd(0.02, momentum=0.9).init(jparams)
    path = str(tmp_path_factory.mktemp('ckpt') / 'epoch_1.pkl')
    save_checkpoint(path, jparams, opt_state,
                    dict(epoch=1, CLASSES=('a', 'b')))
    return path, params


def test_checkpoint_loads_the_converted_tree(checkpoint):
    path, params = checkpoint
    with open(path, 'rb') as f:
        optimizer = pickle.load(f)['optimizer']
    assert type(optimizer[0]).__module__.startswith('optax')
    state, meta, _, _ = load_checkpoint(path)
    want = params_to_state_dict(params)
    assert sorted(state) == sorted(want)
    for k in want:
        assert state[k].dtype == torch.float32
        torch.testing.assert_close(state[k], want[k], rtol=0, atol=0)
    assert tuple(state['backbone.conv1.weight'].shape) == (4, 2, 3, 3)
    assert meta['epoch'] == 1 and tuple(meta['CLASSES']) == ('a', 'b')


_NO_JAX = '''
import sys
sys.modules['jax'] = sys.modules['optax'] = None   # importing them raises
from arfe_tpu_torch.utils import load_checkpoint
state, meta, _, _ = load_checkpoint(sys.argv[1])
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'arfe_tpu'))
print(sorted(state), meta['epoch'], bad)
sys.exit(1 if bad else 0)
'''


def test_checkpoint_loads_without_jax(checkpoint):
    path, params = checkpoint
    proc = subprocess.run([sys.executable, '-c', _NO_JAX, path], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert str(sorted(params_to_state_dict(params))) in proc.stdout
