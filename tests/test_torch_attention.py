"""Kernel A's plain version and NonLocal2D against the JAX package on the
CPU (``fused_softmax_attention`` takes its XLA einsum path off the TPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arfe_tpu.ops.non_local import NonLocal2D as JNonLocal2D
from arfe_tpu.ops.pallas_attention import fused_softmax_attention as j_attn
from arfe_tpu_torch.convert import params_to_state_dict
from arfe_tpu_torch.ops import fused_attention as fa
from arfe_tpu_torch.ops.non_local import NonLocal2D


def _qkv(b, n, c, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, n, c) * scale).astype(np.float32) for _ in range(3)]


# ragged N (77 is no multiple of a 64-query tile); logits unscaled as in
# AR-FPN (use_scale=False) or scaled by 1/sqrt(C)
@pytest.mark.parametrize('b,n,c,scale', [(2, 77, 64, None),
                                         (1, 130, 256, None),
                                         (2, 77, 128, 128 ** -0.5)])
def test_attention_plain_matches_jax_f32(b, n, c, scale):
    q, k, v = _qkv(b, n, c, 0, scale=0.3)
    want = np.asarray(j_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             scale))
    got = fa.fused_softmax_attention(*map(torch.from_numpy, (q, k, v)), scale)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_attention_plain_matches_jax_bf16():
    """bf16 inputs, f32 output; p rounded to bf16 before PV on both sides.
    Tolerance: one bf16 rounding of p (2^-9 relative) may land differently
    where the two softmaxes differ in the last f32 bit."""
    q, k, v = _qkv(2, 77, 64, 1, scale=0.3)
    want = np.asarray(j_attn(*(jnp.asarray(x, jnp.bfloat16)
                               for x in (q, k, v))))
    got = fa.fused_softmax_attention(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want,
                               atol=2.0 ** -8 * np.abs(v).max())


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 8, 64)
    with pytest.raises(ValueError):
        fa.fused_attention_cuda(q, q, q)


def test_non_local_matches_jax():
    c = 64
    jm = JNonLocal2D(c, reduction=1, use_scale=False)
    params = jax.tree_util.tree_map(np.array, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(2)
    # conv_out is zero-initialised; make it nonzero so attention matters
    params['conv_out']['conv']['weight'] = rng.randn(
        1, 1, c, c).astype(np.float32) * 0.05
    params['conv_out']['conv']['bias'] = rng.randn(c).astype(np.float32)
    x = rng.randn(2, 7, 11, c).astype(np.float32)
    want = np.asarray(jm(jax.tree_util.tree_map(jnp.asarray, params),
                         jnp.asarray(x)))
    tm = NonLocal2D(c, reduction=1, use_scale=False)
    tm.load_state_dict(params_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5)
    assert np.abs(want - x).max() > 1e-2
