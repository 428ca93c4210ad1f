"""Fused softmax attention: ``softmax(q @ k^T * scale) @ v`` with f32 output.

Counterpart of ``arfe_tpu/ops/pallas_attention.py``
(``attention_auto``). :func:`fused_softmax_attention` runs
:class:`AttentionFunction`: on a CUDA tensor its forward launches the
hand-written kernel in ``csrc/fused_attention.cu``; on a CPU tensor it runs
:func:`attention_plain`, the plain PyTorch version the kernel is held
against. There is no fallback from one to the other. The backward is the
VJP of :func:`attention_plain`, as the JAX package's is the VJP of its XLA
version (``pallas_attention.py:141-145``): there is no backward kernel to
port.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import library

#: kernel launches since the last reset (``launches = 0``)
launches = 0

_SUPPORTED_C = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fused_attention_cuda(q, k, v, scale=None):
    """Launch the CUDA kernel; q, k, v (B, N, C) contiguous on one device."""
    global launches
    for t in (q, k, v):
        if t.device.type != 'cuda' or t.device != q.device:
            raise ValueError('fused attention: q, k, v must be on one CUDA '
                             'device')
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise TypeError(f'fused attention: dtype {t.dtype} not supported '
                            '(f32 or bf16, the same for q, k, v)')
        if t.shape != q.shape or t.dim() != 3:
            raise ValueError(f'fused attention: shapes {tuple(q.shape)}, '
                             f'{tuple(k.shape)}, {tuple(v.shape)} must be '
                             'equal (B, N, C)')
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError('fused attention: inputs must be contiguous and '
                             '16-byte aligned')
    b, n, c = q.shape
    if c not in _SUPPORTED_C:
        raise ValueError(f'fused attention: C={c} not in {_SUPPORTED_C}')
    out = torch.empty((b, n, c), dtype=torch.float32, device=q.device)
    fn = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, n, c, 1.0 if scale is None else float(scale),
                 _DTYPES[q.dtype], stream)
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

    A CPU tensor takes :func:`attention_plain`; a CUDA tensor the kernel.
    ``scale=None`` leaves the logits unscaled. Differentiable in q, k, v.
    """
    return AttentionFunction.apply(q, k, v, scale)
