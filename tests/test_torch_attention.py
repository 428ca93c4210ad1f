"""Kernel A's plain version and NonLocal2D against the JAX package on the
CPU (``fused_softmax_attention`` takes its XLA einsum path off the TPU)."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_arrff import FAST_COMPILE
from test_torch_threads import one_torch_thread  # noqa: F401

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
    # compiled (op by op, each op compiles)
    params = jax.tree_util.tree_map(np.array, jax.jit(
        jm.init, compiler_options=FAST_COMPILE)(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(2)
    # conv_out is zero-initialised; make it nonzero so attention matters
    params['conv_out']['conv']['weight'] = rng.randn(
        1, 1, c, c).astype(np.float32) * 0.05
    params['conv_out']['conv']['bias'] = rng.randn(c).astype(np.float32)
    x = rng.randn(2, 7, 11, c).astype(np.float32)
    want = np.asarray(jax.jit(jm.__call__, compiler_options=FAST_COMPILE)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x)))
    tm = NonLocal2D(c, reduction=1, use_scale=False)
    tm.load_state_dict(params_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5)
    assert np.abs(want - x).max() > 1e-2


def _split_attention(q, k, v, splits, tile=64):
    """Attention over ``splits`` runs of whole ``tile``-key tiles, merged as
    the bf16 kernel merges them: split s keeps its row max m_s, row sum l_s
    and unnormalised output O_s (keys past N masked to -inf, a split with
    no valid key m_s = -inf, l_s = 0, O_s = 0), and
    O = sum_s e^(m_s - M) O_s / sum_s e^(m_s - M) l_s, M = max_s m_s, over
    the splits with l_s > 0."""
    b, n, c = q.shape
    tiles = -(-n // tile)
    width = -(-tiles // splits) * tile   # keys per split
    logits = torch.full((b, n, splits * width), float('-inf'))
    logits[:, :, :n] = q @ k.transpose(-1, -2)
    vals = torch.zeros((b, splits * width, c))
    vals[:, :n] = v
    ms, ls, outs = [], [], []
    for s in range(splits):
        x = logits[:, :, s * width:(s + 1) * width]
        m = x.amax(-1, keepdim=True)
        p = torch.exp(x - torch.where(torch.isfinite(m), m, torch.zeros(())))
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        outs.append(p @ vals[:, s * width:(s + 1) * width])
    big = torch.stack(ms).amax(0)
    num, den = torch.zeros((b, n, c)), torch.zeros((b, n, 1))
    for m, l, o in zip(ms, ls, outs):
        w = torch.where(l > 0, torch.exp(m - big), torch.zeros(()))
        num, den = num + w * o, den + w * l
    return num / den


# N = 77: a ragged last tile; N = 128: whole tiles. With 3 splits of 2 key
# tiles, the third split holds no valid key (entirely masked).
@pytest.mark.parametrize('splits', [1, 2, 3])
@pytest.mark.parametrize('n', [77, 128])
def test_key_split_merge_matches_plain_and_jax(n, splits):
    q, k, v = _qkv(2, n, 64, 3, scale=0.5)
    got = _split_attention(*map(torch.from_numpy, (q, k, v)), splits)
    assert bool(torch.isfinite(got).all())
    want = fa.attention_plain(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    want_jax = np.asarray(j_attn(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v)))
    np.testing.assert_allclose(got.numpy(), want_jax, atol=1e-5)


@pytest.mark.parametrize('b,n,want', [(1, 4200, 4), (2, 4200, 2),
                                      (1, 4096, 4), (1, 77, 2)])
def test_key_splits_fill_the_card(b, n, want):
    """On 132 SMs of two block slots each: B=1 at N=4200 gets four splits
    (264 blocks of 64 query rows), B=2 two; no split is ever left without a
    key tile."""
    splits = fa.key_splits(b, n, 132)
    assert splits == want
    tiles = -(-n // 64)
    per = -(-tiles // splits)
    assert (splits - 1) * per < tiles
    if n == 4200:
        assert tiles * b * splits >= 2 * 132


@pytest.mark.parametrize('b,n,want', [(1, 4200, 4), (2, 4200, 2),
                                      (1, 77, 3)])
def test_key_splits_fill_the_card_f32(b, n, want):
    """The f32 kernel (128 query rows and 32 keys per tile, one block per
    SM): B=1 at N=4200 gets four splits (132 blocks), B=2 two; no split is
    ever left without a key tile."""
    splits = fa.key_splits(b, n, 132, torch.float32)
    assert splits == want
    query_tile, key_tile, _ = fa.TILES[torch.float32]
    tiles = -(-n // key_tile)
    per = -(-tiles // splits)
    assert (splits - 1) * per < tiles
    if n == 4200:
        assert -(-n // query_tile) * b * splits == 132


def test_key_tile_is_the_kernels_tile():
    """``key_splits`` counts tiles of each kernel's own size."""
    src = (Path(fa.__file__).parent.parent / 'csrc'
           / 'fused_attention.cu').read_text()
    for dtype, (bq, bk) in ((torch.bfloat16, ('BQ', 'BK')),
                            (torch.float32, ('BQ32', 'BK32'))):
        query_tile, key_tile, _ = fa.TILES[dtype]
        assert f'constexpr int {bq} = {query_tile};' in src
        assert f'constexpr int {bk} = {key_tile};' in src


def _tf32(x, nearest=True):
    """f32 to tf32, as ``cvt.rna.tf32.f32`` rounds (to nearest on the low 13
    mantissa bits, ties away from zero) or as the tensor cores read an f32
    operand (``nearest=False``: the low 13 bits dropped)."""
    bits = x.contiguous().view(torch.int32)
    if nearest:
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def _tf32_product(a, b, passes):
    """``a @ b`` in TF32 as the f32 kernel takes it: one pass rounds both
    operands to tf32; three split each into big = tf32(x) + small = x - big
    (read with its low bits dropped) and add small*big, big*small and
    big*big. The products of tf32 values are exact; they are summed in f64,
    so that only the tf32 rounding differs from the exact product."""
    a_big, b_big = _tf32(a), _tf32(b)
    if passes == 1:
        return a_big.double() @ b_big.double()
    a_small = _tf32(a - a_big, nearest=False)
    b_small = _tf32(b - b_big, nearest=False)
    return (a_small.double() @ b_big.double() + a_big.double()
            @ b_small.double() + a_big.double() @ b_big.double())


@pytest.mark.parametrize('passes,within', [(3, True), (1, False)])
def test_attention_needs_three_tf32_products(passes, within):
    """The f32 kernel's arithmetic, emulated: at the card check's inputs
    (randn q, k, v, C = 256; N = 600) attention with both products in
    3xTF32 stays within the f32 tolerance (1e-4) of ``attention_plain``,
    and with one TF32 product it does not (its logits, which reach ~100,
    keep 10 mantissa bits): why the kernel takes three products. (The f32
    sums of ``attention_plain`` itself are ~3e-5 off the exact result.)"""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 600, 256, 5))
    s = _tf32_product(q, k.transpose(-1, -2), passes)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    got = _tf32_product(p.float(), v, passes) / p.sum(-1, keepdim=True)
    err = (got - fa.attention_plain(q, k, v).double()).abs().max().item()
    assert (err <= 1e-4) == within, err
