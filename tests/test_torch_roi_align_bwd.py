"""Kernel C's plain version, the RoIAlign feature gradient, on the CPU:
against torch autograd of the plain forward, against ``jax.vjp`` of the JAX
package's ``roi_align_pyramid`` for every kind of box, and against the
Pallas backward kernel (interpret mode) for the boxes its window covers.
The gradient reaches the levels through ``RoIAlignFunction`` in their
dtypes, and the RoIs get none."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_detector import FAST_COMPILE
from test_torch_threads import one_torch_thread  # noqa: F401

from arfe_tpu.ops import map_roi_levels as j_map_roi_levels
from arfe_tpu.ops import roi_align_pyramid as j_roi_align_pyramid
from arfe_tpu.ops.pallas_roi_align import roi_align_pallas_bwd
from arfe_tpu_torch.ops import roi_align as ra

STRIDES = (4, 8, 16, 32)
IMG_H, IMG_W = 128, 192


def _feats(c, seed, b=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, IMG_H // s, IMG_W // s, c).astype(np.float32)
            for s in STRIDES]


def _edge_rois(seed, b=2):
    """Random boxes plus inverted, zero-size, border-crossing and outside
    boxes (the boxes of tests/test_torch_roi_align.py), and a repeat of the
    first box so that two RoIs add into the same pixels."""
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
    boxes = np.concatenate([boxes, special, boxes[:1]]).astype(np.float32)
    bidx = rng.randint(0, b, (len(boxes), 1)).astype(np.float32)
    bidx[-1] = bidx[0]
    return np.concatenate([bidx, boxes], 1)


def _levels(rois, shift):
    lvls = np.asarray(j_map_roi_levels(jnp.asarray(rois), 4, 56)) + shift
    return np.clip(lvls, 0, 3).astype(np.int32)


def _cotangent(r, c, seed):
    return np.random.RandomState(seed).randn(r, 7, 7, c).astype(np.float32)


@pytest.mark.parametrize('shift,channels', [(0, 16), (1, 8), (-1, 32)])
def test_plain_backward_matches_autograd(shift, channels):
    feats = [torch.from_numpy(f).requires_grad_()
             for f in _feats(channels, 10 + channels)]
    rois = _edge_rois(11)
    trois, lvls = torch.from_numpy(rois), torch.from_numpy(_levels(rois,
                                                                   shift))
    g = torch.from_numpy(_cotangent(len(rois), channels, 12))
    out = ra.roi_align_pyramid_plain(feats, trois, lvls, (7, 7), STRIDES, 2)
    want = torch.autograd.grad(out, feats, g)
    got = ra.roi_align_backward_plain(g, trois, lvls,
                                      [f.shape for f in feats], (7, 7),
                                      STRIDES, 2)
    # both add up to ~200 f32 terms per pixel (values up to ~16) in orders
    # that differ, and CPU index_add_ / index_put_ order varies from run to
    # run: 1e-6 of the level's largest gradient, a few ulps of its sums
    for w, d in zip(want, got):
        assert d.dtype == torch.float32 and d.shape == w.shape
        np.testing.assert_allclose(d.numpy(), w.numpy(),
                                   atol=1e-6 * max(1.0, w.abs().max().item()))


@pytest.mark.parametrize('shift', [0, 1, -1])
def test_plain_backward_matches_jax_vjp(shift):
    c = 16
    feats = _feats(c, 20 + shift)
    rois = _edge_rois(21)
    lvls = _levels(rois, shift)
    g = _cotangent(len(rois), c, 22)

    def feature_vjp(f, r, lv, cot):
        _, vjp = jax.vjp(lambda x: j_roi_align_pyramid(
            list(x), r, (7, 7), STRIDES, 56, 2, True, target_lvls=lv), f)
        return vjp(cot)[0]
    want = jax.jit(feature_vjp, compiler_options=FAST_COMPILE)(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois),
        jnp.asarray(lvls), jnp.asarray(g))
    got = ra.roi_align_backward_plain(
        torch.from_numpy(g), torch.from_numpy(rois), torch.from_numpy(lvls),
        [f.shape for f in feats], (7, 7), STRIDES, 2)
    for w, d in zip(want, got):
        np.testing.assert_allclose(d.numpy(), np.asarray(w), atol=1e-5)


def test_plain_backward_matches_pallas_interpret():
    """In-window RoIs only: the Pallas kernel clips RoIs to its window, and
    for RoIs it does not clip it is the exact transpose (the hand-placed
    boxes of tests/test_pallas_roi_align.py, small and large windows)."""
    b, c = 2, 128
    rng = np.random.RandomState(3)
    feats = [rng.randn(b, 128 // 2 ** i, 192 // 2 ** i, c).astype(np.float32)
             for i in range(4)]
    rois = np.array([
        [0, 100, 100, 180, 180],
        [1, 60, 120, 260, 320],
        [0, 200, 100, 370, 150],
        [1, 80, 180, 130, 350],
        [0, 40, 40, 600, 580],
        [1, 300, 200, 420, 330],
        [0, 40, 100, 424, 196],
        [1, 60, 24, 156, 408],
    ], np.float32)
    g = _cotangent(len(rois), c, 4)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda cot, r: roi_align_pallas_bwd(
            cot, r, [f.shape for f in feats], STRIDES, 56, 2, True),
            compiler_options=FAST_COMPILE)(jnp.asarray(g), jnp.asarray(rois))
    trois = torch.from_numpy(rois)
    got = ra.roi_align_backward_plain(
        torch.from_numpy(g), trois, ra.map_roi_levels(trois, 4, 56),
        [f.shape for f in feats], (7, 7), STRIDES, 2)
    for w, d in zip(want, got):
        np.testing.assert_allclose(d.numpy(), np.asarray(w), atol=1e-3)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_roi_align_pyramid_gradient_reaches_levels(dtype):
    """The autograd path through RoIAlignFunction: the plain backward's
    numbers, in each level's dtype, and no gradient for the RoIs."""
    feats = [torch.from_numpy(f).to(dtype).requires_grad_()
             for f in _feats(8, 30)]
    rois = torch.from_numpy(_edge_rois(31)).requires_grad_()
    lvls = ra.map_roi_levels(rois.detach(), 4)
    out = ra.roi_align_pyramid(feats, rois, lvls, (7, 7), STRIDES, 0)
    assert out.dtype == dtype and out.grad_fn is not None
    g = torch.from_numpy(_cotangent(len(rois), 8, 32)).to(dtype)
    got = torch.autograd.grad(out, feats + [rois], g, allow_unused=True)
    want = ra.roi_align_backward_plain(g, rois.detach(), lvls,
                                       [f.shape for f in feats], (7, 7),
                                       STRIDES, 2)
    assert got[-1] is None
    for d, w in zip(got[:-1], want):
        assert d.dtype == dtype
        assert torch.equal(d, w.to(dtype))


def _axis_footprint(i0, i1, w0, w1, valid, out, sn):
    """One axis of one RoI as kernel C reduces it: the distinct pixels
    (sorted) that the corners of its valid samples touch, and the (out,
    pixels) weight of each bin on them, its samples' corner weights summed
    (zero for an invalid sample)."""
    pix = torch.unique(torch.cat([i0[valid], i1[valid]]))
    weights = torch.zeros((out, len(pix)))
    bins = torch.arange(out * sn) // sn
    for idx, wgt in ((i0, w0), (i1, w1)):
        weights.index_put_((bins[valid], torch.searchsorted(pix, idx[valid])),
                           wgt[valid], accumulate=True)
    return pix, weights


@pytest.mark.parametrize('shift', [0, 1, -1])
def test_separable_footprint_matches_plain(shift):
    """Kernel C's design on the CPU: each RoI adds Wy^T g Wx / sn^2 over the
    distinct rows and columns its samples touch, at most 2 * 7 * 2 = 28 of
    each however large the box, and the sum over RoIs equals
    ``roi_align_backward_plain`` (every kind of box of ``_edge_rois``:
    inverted, empty, on and past the border, fully outside; levels shifted
    off the scale's)."""
    c, sn = 8, 2
    rois = _edge_rois(50)
    trois = torch.from_numpy(rois)
    tlvls = torch.from_numpy(_levels(rois, shift))
    g = torch.from_numpy(_cotangent(len(rois), c, 51))
    shapes = [(2, IMG_H // s, IMG_W // s, c) for s in STRIDES]
    sizes = [b * h * w for b, h, w, _ in shapes]
    ys, xs, base, width = ra.axis_samples([s[:3] for s in shapes], trois,
                                          tlvls, (7, 7), STRIDES, sn)
    table = torch.zeros((sum(sizes), c))
    footprints = []
    for r in range(len(rois)):
        rows, wy = _axis_footprint(*(t[r] for t in ys), 7, sn)
        cols, wx = _axis_footprint(*(t[r] for t in xs), 7, sn)
        assert len(rows) <= 2 * 7 * sn and len(cols) <= 2 * 7 * sn
        footprints.append(len(rows) * len(cols))
        part = torch.einsum('pi,pqc,qj->ijc', wy, g[r], wx) / sn ** 2
        idx = base[r] + rows[:, None] * width[r] + cols[None, :]
        table.index_add_(0, idx.reshape(-1), part.reshape(-1, c))
    # the fully outside box touches nothing; small boxes share pixels
    assert min(footprints) == 0 and 0 < sorted(footprints)[1] < 14 * 14
    want = ra.roi_align_backward_plain(g, trois, tlvls, shapes, (7, 7),
                                       STRIDES, sn)
    for d, w in zip(table.split(sizes), want):
        np.testing.assert_allclose(d.reshape(w.shape).numpy(), w.numpy(),
                                   atol=1e-5)


def test_backward_wrapper_refuses_cpu_tensors():
    feats = _feats(8, 40)
    rois = torch.from_numpy(_edge_rois(41))
    g = torch.zeros((len(rois), 7, 7, 8))
    with pytest.raises(ValueError):
        ra.roi_align_backward_cuda(g, rois, ra.map_roi_levels(rois, 4),
                                   [f.shape for f in feats])
