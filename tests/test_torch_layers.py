"""Port primitives (``arfe_tpu_torch.layers``) against ``arfe_tpu.layers`` on
the CPU: the same numpy inputs and converted weights, f32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arfe_tpu import layers as jl
from arfe_tpu_torch import layers as tl
from arfe_tpu_torch.convert import params_to_state_dict

ATOL = 1e-5


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _random_params(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if a.ndim == 1 else rng.randn(*a.shape).astype(np.float32) * 0.2,
        params)


@pytest.mark.parametrize('kind', ['conv3x3_s2', 'conv1x1', 'conv_bn_relu',
                                  'linear'])
def test_module_matches_jax(kind):
    rng = np.random.RandomState(0)
    if kind == 'conv3x3_s2':
        jm = jl.Conv2d(8, 16, 3, stride=2, padding=1)
        tm = tl.Conv2d(8, 16, 3, stride=2, padding=1)
    elif kind == 'conv1x1':
        jm = jl.Conv2d(8, 16, 1, bias=False)
        tm = tl.Conv2d(8, 16, 1, bias=False)
    elif kind == 'conv_bn_relu':
        jm = jl.ConvModule(8, 16, 3, padding=1, norm_cfg=dict(type='BN'))
        tm = tl.ConvModule(8, 16, 3, padding=1, norm_cfg=dict(type='BN'))
    else:
        jm = jl.Linear(24, 10)
        tm = tl.Linear(24, 10)
    params = _random_params(jm.init(jax.random.PRNGKey(1)), 1)
    tm.load_state_dict(params_to_state_dict(params), strict=True)
    if kind == 'linear':
        x = rng.randn(5, 24).astype(np.float32)
        want = np.asarray(jm(params, jnp.asarray(x)))
        got = tm(torch.from_numpy(x)).detach().numpy()
    else:
        x = rng.randn(2, 13, 21, 8).astype(np.float32)
        want = np.asarray(jm(params, jnp.asarray(x)))
        got = _nhwc(tm(_nchw(x)).detach())
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize('pool', [(1, 2, 0), (3, 2, 1)])
def test_max_pool2d(pool):
    k, s, p = pool
    x = np.random.RandomState(2).randn(2, 25, 42, 4).astype(np.float32)
    want = np.asarray(jl.max_pool2d(jnp.asarray(x), k, stride=s, padding=p))
    got = _nhwc(tl.max_pool2d(_nchw(x), k, stride=s, padding=p))
    np.testing.assert_array_equal(got, want)


# (src h, w) -> (dst h, w): the AR-FPN gathers 200x336 / 100x168 down to the
# refine level 50x84 and resizes 13x21 (P6 at 800x1344) up to it, then
# resizes the refined map back to every level; 13 <-> 50 is not an integer
# ratio
@pytest.mark.parametrize('src,dst', [((50, 84), (13, 21)),
                                     ((37, 53), (13, 21)),
                                     ((100, 168), (50, 84)),
                                     ((7, 9), (3, 4))])
def test_adaptive_max_pool2d(src, dst):
    x = np.random.RandomState(3).randn(1, *src, 3).astype(np.float32)
    want = np.asarray(jl.adaptive_max_pool2d(jnp.asarray(x), dst))
    got = _nhwc(tl.adaptive_max_pool2d(_nchw(x), dst))
    np.testing.assert_array_equal(got, want)
    ref = torch.nn.functional.adaptive_max_pool2d(_nchw(x), dst)
    np.testing.assert_array_equal(got, _nhwc(ref))


@pytest.mark.parametrize('src,dst', [((13, 21), (50, 84)),
                                     ((50, 84), (13, 21)),
                                     ((25, 42), (50, 84)),
                                     ((50, 84), (200, 336)),
                                     ((7, 9), (20, 30))])
def test_resize_nearest(src, dst):
    x = np.random.RandomState(4).randn(1, *src, 3).astype(np.float32)
    want = np.asarray(jl.resize_nearest(jnp.asarray(x), dst))
    got = _nhwc(tl.resize_nearest(_nchw(x), dst))
    np.testing.assert_array_equal(got, want)


def test_init_weights_is_seeded():
    a, b = tl.ConvModule(4, 8, 3), tl.ConvModule(4, 8, 3)
    tl.init_weights(a, torch.Generator().manual_seed(5))
    tl.init_weights(b, torch.Generator().manual_seed(5))
    assert torch.equal(a.conv.weight, b.conv.weight)
    assert a.conv.weight.std() > 0
