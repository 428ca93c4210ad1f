"""The port's NMS against the JAX package's on the CPU: the same kept boxes,
scores, indices, labels and padding, exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_arrff import FAST_COMPILE
from test_torch_threads import one_torch_thread  # noqa: F401

from arfe_tpu.core.post.bbox_nms import multiclass_nms as j_multiclass_nms
from arfe_tpu.ops.nms import batched_nms as j_batched_nms
from arfe_tpu.ops.nms import nms as j_nms
from arfe_tpu_torch.core.post import multiclass_nms
from arfe_tpu_torch.ops import nms as tn


def _boxes(n, seed, spread=100.0):
    """Clustered boxes (long suppression chains) with repeated scores."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(0, spread, (n // 8 + 1, 2))
    c = centers[rng.randint(0, len(centers), n)] + rng.randn(n, 2) * 4
    wh = rng.uniform(5, 30, (n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    scores = np.round(rng.uniform(0, 1, n), 2).astype(np.float32)  # ties
    return boxes, scores


def _jit(fn):
    """``fn`` compiled once at XLA's lowest optimisation level (called op
    by op, its loops compile at the default level)."""
    return jax.jit(fn, compiler_options=FAST_COMPILE)


def _assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize('n,max_out,masked', [(300, 100, False),
                                              (300, 100, True),
                                              (40, 64, True)])
def test_nms_matches_jax(n, max_out, masked):
    boxes, scores = _boxes(n, n + max_out)
    valid = np.random.RandomState(1).rand(n) > 0.2 if masked else None
    want = _jit(lambda b, s, v: j_nms(b, s, 0.5, max_out=max_out,
                                      valid_mask=v))(
        jnp.asarray(boxes), jnp.asarray(scores),
        None if valid is None else jnp.asarray(valid))
    got = tn.nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5,
                 max_out=max_out,
                 valid_mask=None if valid is None else torch.from_numpy(valid))
    assert int(got[2].sum()) > 0
    _assert_same(got, want)


def test_nms_batched_equals_per_problem():
    boxes = np.stack([_boxes(64, s)[0] for s in range(3)])
    scores = np.stack([_boxes(64, s)[1] for s in range(3)])
    dets, idx, valid = tn.nms_batched(torch.from_numpy(boxes),
                                      torch.from_numpy(scores), 0.6, 32)
    for p in range(3):
        one = tn.nms(torch.from_numpy(boxes[p]), torch.from_numpy(scores[p]),
                     0.6, 32)
        _assert_same((dets[p], idx[p], valid[p]), one)


def test_batched_nms_matches_jax():
    boxes, scores = _boxes(200, 7)
    idxs = np.random.RandomState(7).randint(0, 5, 200).astype(np.int32)
    cfg = dict(type='nms', iou_thr=0.5)
    want = _jit(lambda b, s, i: j_batched_nms(b, s, i, cfg, max_out=80))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(idxs))
    got = tn.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                         torch.from_numpy(idxs), cfg, max_out=80)
    _assert_same(got, want)


def test_multiclass_nms_matches_jax():
    rng = np.random.RandomState(8)
    b, n, k = 2, 60, 6
    boxes = np.stack([np.tile(_boxes(n, 10 + i)[0], (1, k))
                      + rng.randn(n, 4 * k).astype(np.float32)
                      for i in range(b)]).astype(np.float32)
    logits = rng.randn(b, n, k + 1).astype(np.float32) * 2
    scores = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    valid = rng.rand(b, n) > 0.1
    cfg = dict(type='nms', iou_thr=0.5)
    got = multiclass_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                         0.05, cfg, 30, pre_nms_cap=150,
                         valid_mask=torch.from_numpy(valid))
    reference = _jit(lambda bx, sc, v: j_multiclass_nms(
        bx, sc, 0.05, cfg, 30, pre_nms_cap=150, valid_mask=v))
    for i in range(b):
        want = reference(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                         jnp.asarray(valid[i]))
        assert got[1].dtype == torch.int32
        _assert_same([t[i] for t in got], want)
