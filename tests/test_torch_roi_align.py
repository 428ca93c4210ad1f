"""Kernel B's plain version and the RoI extractor against the JAX package on
the CPU: the plain ``roi_align_pyramid`` for every kind of box, and the
Pallas kernel (interpret mode) for the boxes its window covers. The JAX
references run compiled (``jax.jit``): op by op, each of their first calls
compiles every primitive apart, which takes seconds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_detector import FAST_COMPILE
from test_torch_threads import one_torch_thread  # noqa: F401

from arfe_tpu.models.roi_heads.roi_extractors.single_level import \
    SingleRoIExtractor as JExtractor
from arfe_tpu.ops import map_roi_levels as j_map_roi_levels
from arfe_tpu.ops import roi_align_pyramid as j_roi_align_pyramid
from arfe_tpu.ops.pallas_roi_align import roi_align_pallas
from arfe_tpu_torch.models.roi_heads.roi_extractors import SingleRoIExtractor
from arfe_tpu_torch.ops import roi_align as ra

STRIDES = (4, 8, 16, 32)
IMG_H, IMG_W = 128, 192


def _feats(c, seed, b=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, IMG_H // s, IMG_W // s, c).astype(np.float32)
            for s in STRIDES]


def _edge_rois(seed, b=2):
    """Random boxes plus inverted, zero-size, border-crossing and outside
    boxes."""
    rng = np.random.RandomState(seed)
    n = 24
    xy = rng.uniform(0, [IMG_W, IMG_H], (n, 2))
    wh = np.exp(rng.uniform(0, 5.5, (n, 2)))
    boxes = np.concatenate([xy, xy + wh], 1)
    special = np.array([
        [60, 40, 20, 90],                  # inverted x
        [30, 80, 90, 20],                  # inverted y
        [50, 50, 50, 50],                  # zero size
        [70, 30, 70, 100],                 # zero width
        [-30, -20, 40, 50],                # past the top-left
        [150, 100, 230, 160],              # past the bottom-right
        [0, 0, IMG_W, IMG_H],              # the whole image, on the border
        [IMG_W + 5, 10, IMG_W + 40, 50],   # fully outside
        [-1.0, -1.0, 3.0, 3.0],            # samples at the -1 edge
    ], np.float32)
    boxes = np.concatenate([boxes, special]).astype(np.float32)
    bidx = rng.randint(0, b, (len(boxes), 1)).astype(np.float32)
    return np.concatenate([bidx, boxes], 1)


def test_map_roi_levels_matches_jax():
    rois = _edge_rois(0)
    want = np.asarray(j_map_roi_levels(jnp.asarray(rois), 4, 56))
    got = ra.map_roi_levels(torch.from_numpy(rois), 4, 56)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('shift', [0, 1, -1])
def test_plain_matches_jax_pyramid(shift):
    feats = _feats(32, 1)
    rois = _edge_rois(1)
    lvls = np.clip(np.asarray(j_map_roi_levels(jnp.asarray(rois), 4, 56))
                   + shift, 0, 3).astype(np.int32)
    want = np.asarray(jax.jit(
        lambda f, r, lv: j_roi_align_pyramid(f, r, (7, 7), STRIDES, 56, 2,
                                             True, target_lvls=lv),
        compiler_options=FAST_COMPILE)(
            [jnp.asarray(f) for f in feats], jnp.asarray(rois),
            jnp.asarray(lvls)))
    got = ra.roi_align_pyramid([torch.from_numpy(f) for f in feats],
                               torch.from_numpy(rois), torch.from_numpy(lvls),
                               (7, 7), STRIDES, 0, True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_plain_matches_pallas_interpret():
    """In-window RoIs only: the Pallas kernel clips extreme aspect ratios
    into its (48, 64) window."""
    b, c = 2, 128
    rng = np.random.RandomState(2)
    feats = [rng.randn(b, 100 // 2 ** i + 1, 168 // 2 ** i, c)
             .astype(np.float32) for i in range(4)]
    r = 16
    xy = rng.uniform(0, 300, (r, 2))
    wh = rng.uniform(20, 200, (r, 2))
    rois = np.concatenate([rng.randint(0, b, (r, 1)), xy, xy + wh],
                          1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(
            lambda f, r: roi_align_pallas(f, r, (7, 7), STRIDES, 56, 2, True),
            compiler_options=FAST_COMPILE)(
                [jnp.asarray(f) for f in feats], jnp.asarray(rois)))
    trois = torch.from_numpy(rois)
    got = ra.roi_align_pyramid([torch.from_numpy(f) for f in feats], trois,
                               ra.map_roi_levels(trois, 4, 56), (7, 7),
                               STRIDES, 2, True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize('extra', ['none', 'lvl', 'replace_rois',
                                   'roi_scale_factor'])
def test_extractor_matches_jax(extra):
    feats = _feats(16, 3)
    rois = _edge_rois(3)
    kw = {}
    if extra == 'lvl':
        kw['lvl'] = 1
    elif extra == 'replace_rois':
        kw['replace_rois'] = _edge_rois(4)
    elif extra == 'roi_scale_factor':
        kw['roi_scale_factor'] = 1.5
    layer = dict(type='RoIAlign', out_size=7, sample_num=0)
    jx = JExtractor(layer, 16, STRIDES)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    want = np.asarray(jax.jit(lambda f, r: jx({}, f, r, **jkw),
                              compiler_options=FAST_COMPILE)(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois)))
    tx = SingleRoIExtractor(layer, 16, STRIDES)
    got = tx([torch.from_numpy(f.transpose(0, 3, 1, 2).copy())
              for f in feats], torch.from_numpy(rois),
             **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_plain_keeps_bf16():
    feats = [torch.from_numpy(f).to(torch.bfloat16) for f in _feats(8, 5)]
    rois = torch.from_numpy(_edge_rois(5))
    out = ra.roi_align_pyramid(feats, rois, ra.map_roi_levels(rois, 4))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


def test_kernel_wrapper_refuses_cpu_tensors():
    feats = [torch.from_numpy(f) for f in _feats(8, 6)]
    rois = torch.from_numpy(_edge_rois(6))
    with pytest.raises(ValueError):
        ra.roi_align_cuda(feats, rois, ra.map_roi_levels(rois, 4))
