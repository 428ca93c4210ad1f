"""Fused softmax attention: ``softmax(q @ k^T * scale) @ v`` with f32 output.

Counterpart of ``arfe_tpu/ops/pallas_attention.py``
(``attention_auto``). :func:`fused_softmax_attention` runs
:class:`AttentionFunction`: on a CUDA tensor its forward launches the
hand-written kernel in ``csrc/fused_attention.cu`` (bf16 inputs: ``wgmma``;
f32 inputs: ``mma.sync`` in 3xTF32; both on the tensor cores with a key
split); on a CPU tensor it runs
:func:`attention_plain`, the plain PyTorch version the kernel is held
against. There is no fallback from one to the other. The backward is the
VJP of :func:`attention_plain`, as the JAX package's is the VJP of its XLA
version (``pallas_attention.py:141-145``): there is no backward kernel to
port.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import library

#: kernel launches since the last reset (``launches = 0``)
launches = 0

_SUPPORTED_C = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: query rows and keys per tile of each dtype's kernel (``BQ``, ``BK`` and
#: ``BQ32``, ``BK32`` in ``csrc/fused_attention.cu``), and the blocks an SM
#: holds at once at C = 256: two of 99,328 B of shared memory in bf16, one
#: of 207,360 B in f32
TILES = {torch.bfloat16: (64, 64, 2), torch.float32: (128, 32, 1)}
MOST_SPLITS = 16


def attention_plain(q, k, v, scale=None):
    """Both products accumulate in f32; the probabilities are rounded to
    ``v``'s dtype before the PV product, as on the TPU."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if scale is not None:
        s = s * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float())


def _lib():
    lib = library('fused_attention')
    fn = lib.arfe_fused_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=256)
def key_splits(batch, n, sms, dtype=torch.bfloat16):
    """Key splits of ``dtype``'s kernel for ``batch`` images of ``n`` tokens
    on ``sms`` SMs, with that kernel's tiles and blocks per SM
    (:data:`TILES`): the count whose blocks (query tiles x splits x batch)
    take the fewest waves x key tiles per block, the fewer splits on a tie,
    and none that would leave a split without a key tile."""
    query_tile, key_tile, per_sm = TILES[dtype]
    q_tiles = -(-n // query_tile)
    tiles = -(-n // key_tile)
    slots = sms * per_sm
    best, best_cost = 1, None
    for s in range(1, min(tiles, MOST_SPLITS) + 1):
        per = -(-tiles // s)
        if -(-tiles // per) != s:
            continue
        cost = -(-(q_tiles * batch * s) // slots) * per
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def fused_attention_cuda(q, k, v, scale=None):
    """Launch the CUDA kernel; q, k, v (B, N, C) contiguous on one device.

    The input dtype picks the kernel: bf16 runs ``wgmma``, f32 ``mma.sync``
    in 3xTF32, both with the keys split :func:`key_splits` ways for this
    card and that kernel (a merge kernel joins the splits, and the pair
    counts as one launch).
    """
    dev = q.device
    if dev.type != 'cuda' or k.device != dev or v.device != dev:
        raise ValueError('fused attention: q, k, v must be on one CUDA '
                         'device')
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f'fused attention: dtypes {q.dtype}, {k.dtype}, '
                        f'{v.dtype} not supported (f32 or bf16, the same for '
                        'q, k, v)')
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f'fused attention: shapes {tuple(q.shape)}, '
                         f'{tuple(k.shape)}, {tuple(v.shape)} must be equal '
                         '(B, N, C)')
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()) \
            or (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError('fused attention: inputs must be contiguous and '
                         '16-byte aligned')
    b, n, c = q.shape
    if c not in _SUPPORTED_C:
        raise ValueError(f'fused attention: C={c} not in {_SUPPORTED_C}')
    return _launch(q, k, v, scale, key_splits(b, n, _sm_count(dev.index),
                                              q.dtype))


def _launch(q, k, v, scale, splits):
    """The launch of checked inputs with ``splits`` key splits, in key tiles
    of the dtype's kernel. Only :func:`fused_attention_cuda` and the card's
    tests and split timings call it: a forced count may leave a split
    without keys, which the merge skips."""
    global launches
    b, n, c = q.shape
    dev = q.device
    out = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    part_o = part_ml = None
    if splits > 1:
        # the splits' unnormalised outputs (splits, B, N, C), then their row
        # max and sum (splits, B, N, 2)
        scratch = torch.empty(splits * b * n * (c + 2), dtype=torch.float32,
                              device=dev)
        part_o = scratch.data_ptr()
        part_ml = part_o + splits * b * n * c * 4
    with torch.cuda.device(dev):
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), part_o, part_ml, b, n, c,
                     1.0 if scale is None else float(scale), _DTYPES[q.dtype],
                     splits, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f'fused attention kernel launch failed: CUDA '
                           f'error {err}')
    launches += 1
    return out


class AttentionFunction(torch.autograd.Function):
    """``apply(q, k, v, scale)``. Forward: the kernel on CUDA,
    :func:`attention_plain` on the CPU. Backward: recomputes
    :func:`attention_plain` under autograd and takes its VJP; the gradients
    come in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        if q.device.type == 'cpu':
            return attention_plain(q, k, v, scale)
        return fused_attention_cuda(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = attention_plain(*inputs, ctx.scale)
            grads = torch.autograd.grad(out, inputs, g)
        return (*grads, None)


def fused_softmax_attention(q, k, v, scale=None):
    """``softmax(q @ k^T * scale) @ v`` over (B, N, C); returns f32 (B, N, C).

    A CPU tensor takes :func:`attention_plain`; a CUDA tensor the kernel,
    whose design the dtype picks (:func:`fused_attention_cuda`).
    ``scale=None`` leaves the logits unscaled. Differentiable in q, k, v.
    """
    return AttentionFunction.apply(q, k, v, scale)
