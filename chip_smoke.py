"""Smoke run of the PyTorch/CUDA port (``arfe_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

1. Prints the card's name and power limit and builds the CUDA kernels from
   ``arfe_tpu_torch/csrc`` (one ``nvcc`` per source, all at once).
2. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (attention at B=1 and B=2 over N=4200, and its tile
   and key-split edge cases; RoIAlign at R=1000 bs1, R=1024 and R=2000
   bs2), in f32 and bf16, and times kernel, plain version and (where one
   exists) the PyTorch library call by CUDA-graph replay beside each
   kernel's bound, and the RoIAlign gradient as a bf16 training step pays
   it (casts, zero fill and kernel C); checks the
   gradients through the RoIAlign autograd Function (kernels B and C)
   against the plain versions, and that the attention autograd Function
   (kernel A, then the plain version's VJP) gives the plain gradients.
3. Serves the flagship Faster R-CNN R50 + AR-FPN
   (``configs/_base_/models/faster_rcnn_r50_arfpn.py``) at full width on
   ``cuda`` with seeded random weights: four bs1 and two bs2 requests at
   800x1344 in bf16, and two bs1 requests in f32. Every request must launch
   the attention and the RoIAlign forward kernels.
4. Checks the served detector against the same weights on the CPU (plain
   path) on a small image.
5. Trains the flagship at full width with the bench's SGD schedule and
   synthetic batch (``bench.py:150-185``): four bs2 steps at 800x1344 in
   bf16 and one in f32. Every step must launch all three kernels; the frozen
   stem and layer1 must not move; every other tensor must move, unless its
   gradient was exactly 0 in every step (those are named). Then holds
   kernel C against its plain version on the first step's cotangent, RoIs
   and levels, and times it there.
6. Checks one f32 training step on the card against the same weights (the
   trainer's seeded starting weights) and sampling priorities on the CPU
   (plain path) on a small image: losses and gradients.

Prints one JSON line of kernel numbers (``launches`` counts the training
run, ``launches_serve`` the serving run), then the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``. Exits
non-zero, with no result line, if there is no CUDA device or any phase
fails.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from arfe_tpu_torch.tools.timing import card, cuda_ms, host_ms
from arfe_tpu_torch.train import bench
from arfe_tpu_torch.train.bench import FLAGSHIP_CFG, H, IMG_SHAPE, W

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense FLOP/s
# (bf16 and TF32 on the tensor cores, f32 on the FMA units)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TF32_FLOPS = 494.7e12


def build_kernels():
    from arfe_tpu_torch.ops import cuda_build
    t0 = time.time()
    logs = cuda_build.build(['fused_attention', 'roi_align',
                             'roi_align_bwd'])
    print(f'build: {time.time() - t0:.1f} s for {sorted(logs) or "nothing"}')
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if any(w in line for w in ('Function properties', 'registers',
                                       'spill', 'smem', 'warning')):
                print(f'  {name}: {line.strip()}')


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def _attention_bound(b, n, c, dtype):
    """Least time of one attention call, ms, and what bounds it: the two
    products' 4*B*N^2*C operations at the tensor cores' dense peak, or q, k,
    v read once and the f32 output written once. In f32 the products count
    three times at the TF32 peak: 3xTF32 is the least work that gives an
    f32-accurate result on the tensor cores (one TF32 product is off by
    ~1.5e-2, tests/test_torch_attention.py)."""
    isz = torch.tensor([], dtype=dtype).element_size()
    ops = 4.0 * b * n * n * c
    t_ops = (3 * ops / TF32_FLOPS if dtype == torch.float32
             else ops / PEAK_FLOPS[dtype]) * 1e3
    t_bytes = b * n * c * (3 * isz + 4) / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), 'operations' if t_ops >= t_bytes else 'bytes'


def check_attention(gen):
    """Kernel A vs ``attention_plain`` at AR-FPN's refine shape
    (N = 50*84 = 4200 tokens of the stride-16 level, C = 256, no scale) and
    at the edge cases: whole tiles (4096), one ragged tile (77, also with a
    forced split count whose last split is empty: three of 64-key tiles in
    bf16, four of 32-key tiles in f32), the tiny flagship's width (130, 64)
    and (600, 128). Times kernel, plain version and SDPA at B=1 and B=2 in
    bf16, and kernel and SDPA at B=1 and B=2 in f32."""
    from arfe_tpu_torch.ops import fused_attention as fa
    dev = 'cuda'
    bf, f32 = torch.bfloat16, torch.float32
    cases = [(b, n, 256, dt, None) for b in (1, 2) for n in (4200, 77)
             for dt in (f32, bf)]
    cases += [(1, 4096, 256, bf, None), (1, 77, 256, bf, 3),
              (1, 77, 256, f32, 4), (2, 130, 64, bf, None),
              (2, 130, 64, f32, None), (1, 600, 128, bf, None),
              (1, 600, 128, f32, None)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, inputs = [], {}
    for b, n, c, dt, splits in cases:
        q, k, v = (torch.randn((b, n, c), generator=gen, device=dev)
                   .to(dt) for _ in range(3))
        # a forced count goes to the private launcher: key_splits never
        # leaves a split without keys
        got = fa.fused_attention_cuda(q, k, v) if splits is None \
            else fa._launch(q, k, v, None, splits)
        ref = fa.attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        # f32: both sum in f32, in another order; logits reach |q||k| ~ 50.
        # bf16: each side rounds every probability to bf16 once before PV
        # (the bound is derived in csrc/fused_attention.cu)
        tol = 1e-4 if dt == torch.float32 \
            else 2.0 ** -8 * v.float().abs().max().item()
        ok = bool(torch.isfinite(got).all()) and err <= tol
        if dt == f32 and n == 4200:
            # the plain version's own f32 error sets the floor of the
            # comparison: both against an f64 reference
            exact = torch.softmax(q.double() @ k.double().transpose(-1, -2),
                                  -1) @ v.double()
            print(f'attention B={b} N={n} f32 against f64: kernel '
                  f'{(got.double() - exact).abs().max().item():.3e}, plain '
                  f'{(ref.double() - exact).abs().max().item():.3e}')
            del exact
        used = splits or fa.key_splits(b, n, sms, dt)
        blocks = -(-n // fa.TILES[dt][0]) * b * used
        print(f'attention B={b} N={n} C={c} {str(dt)[6:]} splits {used} '
              f'({blocks} blocks): max_abs_err {err:.3e} '
              f'(tol {tol:.3e}) {"ok" if ok else "FAIL"}')
        rows.append(ok)
        if n == 4200 and splits is None:
            inputs[b, dt] = (q, k, v, err)
    times = {}
    for b, dt in ((1, bf), (2, bf), (1, f32), (2, f32)):
        q, k, v, _ = inputs[b, dt]
        q4, k4, v4 = (t[:, None] for t in (q, k, v))
        def kernel():
            return fa.fused_attention_cuda(q, k, v)
        times[b, dt] = (
            cuda_ms(kernel, graph=True),
            cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                           scale=1.0),
                    graph=True),
            _attention_bound(b, 4200, 256, dt), host_ms(kernel))
        ms, lib_ms, (bound, by), host = times[b, dt]
        print(f'attention B={b} N=4200 {str(dt)[6:]}: kernel {ms:.4f} ms '
              f'(an event loop of calls: {cuda_ms(kernel):.4f} ms), sdpa '
              f'{lib_ms:.4f} ms, bound {bound:.4f} ms ({by}); the '
              f'wrapper\'s host time {host:.4f} ms per call')
    q, k, v, err = inputs[1, bf]
    plain_ms = cuda_ms(lambda: fa.attention_plain(q, k, v))
    print(f'attention B=1 N=4200 bf16: plain {plain_ms:.4f} ms')
    # the f32 products on the FMA units, the bound of an f32 FMA kernel
    fma_ms = {b: 4.0 * b * 4200 ** 2 * 256 / PEAK_FLOPS[f32] * 1e3
              for b in (1, 2)}
    print(f'attention N=4200 f32: the FMA units\' bound {fma_ms[1]:.4f} ms '
          f'(B=1), {fma_ms[2]:.4f} ms (B=2)')
    ms, lib_ms, (bound, by), host = times[1, bf]
    ms2, lib_ms2, (bound2, _), _ = times[2, bf]
    ms32, lib_ms32, (bound32, _), host32 = times[1, f32]
    ms32_2, lib_ms32_2, (bound32_2, _), _ = times[2, f32]
    return all(rows), dict(
        name='fused_attention', route='cuda',
        source='arfe_tpu_torch/csrc/fused_attention.cu',
        replaces='arfe_tpu/ops/pallas_attention.py:102',
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=by, library_ms=lib_ms, host_ms=host,
        ms_b2=ms2, library_ms_b2=lib_ms2, bound_ms_b2=bound2,
        max_abs_err_f32=inputs[1, f32][3], ms_f32=ms32,
        library_ms_f32=lib_ms32, bound_ms_f32=bound32, host_ms_f32=host32,
        ms_f32_b2=ms32_2, library_ms_f32_b2=lib_ms32_2,
        bound_ms_f32_b2=bound32_2, bound_ms_f32_fma=fma_ms[1],
        bound_ms_f32_fma_b2=fma_ms[2])


def _test_rois(gen, num, batch, dev):
    """RoIs of every kind the kernel must get right."""
    def u(lo, hi, n):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=dev)
    q = num // 8
    x1, y1 = u(0, W, num), u(0, H, num)
    bw = torch.exp(u(0.0, 6.5, num))      # 1 .. 665 px, every level
    bh = torch.exp(u(0.0, 6.5, num))
    x2, y2 = x1 + bw, y1 + bh
    x1[:q], x2[:q] = x2[:q].clone(), x1[:q].clone()          # inverted x
    y1[q:2 * q], y2[q:2 * q] = y2[q:2 * q].clone(), y1[q:2 * q].clone()
    x2[2 * q:3 * q] = x1[2 * q:3 * q]                         # zero width
    y2[2 * q:3 * q] = y1[2 * q:3 * q]                         # and height
    x1[3 * q:4 * q] -= 60.0                                   # past the left
    y2[3 * q:4 * q] = H + u(0, 80, q)                         # and bottom
    x1[4 * q:4 * q + q // 2] = W + u(0, 40, q // 2)           # fully outside
    x2[4 * q:4 * q + q // 2] = x1[4 * q:4 * q + q // 2] + 30
    x2[4 * q + q // 2:5 * q] = float(W)                       # on the border
    y1[4 * q + q // 2:5 * q] = 0.0
    b = torch.randint(0, batch, (num,), generator=gen, device=dev).float()
    return torch.stack([b, x1, y1, x2, y2], 1).contiguous()


def _roi_align_case(gen, num, batch, strides=(4, 8, 16, 32)):
    """Kernel B vs ``roi_align_pyramid_plain`` for ``num`` RoIs over 4
    levels of (batch, 800/s, 1344/s, 256), in f32 and bf16; half the levels
    mapped by scale, half shifted by +-1. Returns whether both agree, the
    bf16 inputs and error, and the f32 inputs."""
    from arfe_tpu_torch.ops import roi_align as ra
    dev = 'cuda'
    rois = _test_rois(gen, num, batch, dev)
    lvls = ra.map_roi_levels(rois, 4, 56)
    shift = torch.randint(-1, 2, lvls.shape, generator=gen, device=dev)
    shift[:num // 2] = 0
    lvls = torch.clamp(lvls + shift.to(torch.int32), 0, 3).to(torch.int32)
    ok, kept = True, {}
    for dt in (torch.float32, torch.bfloat16):
        feats = [torch.randn((batch, H // s, W // s, 256), generator=gen,
                             device=dev).to(dt) for s in strides]
        got = ra.roi_align_cuda(feats, rois, lvls, (7, 7), strides, 2, True)
        ref = ra.roi_align_pyramid_plain(feats, rois, lvls, (7, 7), strides,
                                         2, True)
        torch.cuda.synchronize()
        d = (got.float() - ref.float()).abs()
        err = d.max().item()
        # f32: the same f32 arithmetic up to FMA contraction in the sum.
        # bf16: both sum the same bf16 inputs in f32; a value near a rounding
        # boundary may round to the neighbour, one bf16 ulp (2^-7 relative).
        if dt == torch.float32:
            allowed, tol = torch.full_like(d, 1e-5), '1e-5'
        else:
            allowed, tol = 2.0 ** -7 * ref.float().abs() + 1e-6, \
                '2^-7 |ref| + 1e-6'
        good = bool((d <= allowed).all()) and bool(torch.isfinite(got).all())
        print(f'roi_align R={num} B={batch} {str(dt)[6:]}: max_abs_err '
              f'{err:.3e} (tol {tol}) {"ok" if good else "FAIL"}')
        if not good:
            worst = int((d - allowed).flatten().argmax())
            r = worst // d[0].numel()
            print(f'  worst at roi {r} {rois[r].tolist()} level '
                  f'{int(lvls[r])}: got {got.flatten()[worst].item()} ref '
                  f'{ref.flatten()[worst].item()}')
        ok = ok and good
        kept[dt] = (feats, rois, lvls, err)
    return ok, kept


def _touched_pixels(level_shapes, rois, lvls, strides=(4, 8, 16, 32)):
    """How many distinct level pixels the RoIs' 7 x 7 x 2 x 2 samples read."""
    from arfe_tpu_torch.ops import roi_align as ra
    corners, valid = ra.sample_corners([s[:3] for s in level_shapes], rois,
                                       lvls, (7, 7), strides, 2, True)
    return torch.unique(torch.cat([idx[valid] for idx, _ in corners])).numel()


def _roi_align_bound(feats, rois, lvls, strides=(4, 8, 16, 32)):
    """Least time of one RoIAlign call, ms: the output written once and the
    distinct feature pixels its samples touch read once, at HBM rate.
    Returns it and the count of those pixels."""
    touched = _touched_pixels([f.shape for f in feats], rois, lvls, strides)
    c, isz = feats[0].shape[-1], feats[0].element_size()
    nbytes = (touched + rois.shape[0] * 49) * c * isz
    return nbytes / HBM_BYTES_PER_S * 1e3, touched


def check_roi_align(gen):
    """Kernel B vs ``roi_align_pyramid_plain`` at the main path's shapes:
    R = 2 x 1000 proposals at bs2 serving (the table's shape), R = 1000 at
    bs1 serving, R = 2 x 512 sampled RoIs at bs2 training; each in f32 and
    bf16, and timed in bf16 beside its bound (and in f32 at R = 2000)."""
    from arfe_tpu_torch.ops import roi_align as ra
    strides = (4, 8, 16, 32)
    row, ok = {}, True
    for num, batch, key in ((2000, 2, ''), (1000, 1, '_r1000'),
                            (1024, 2, '_r1024')):
        good, kept = _roi_align_case(gen, num, batch, strides)
        ok = ok and good
        for dt in ((torch.bfloat16, torch.float32) if num == 2000
                   else (torch.bfloat16,)):
            feats, rois, lvls, err = kept[dt]
            def kernel():
                return ra.roi_align_cuda(feats, rois, lvls, (7, 7), strides,
                                         2, True)
            ms = cuda_ms(kernel, graph=True)
            bound, touched = _roi_align_bound(feats, rois, lvls, strides)
            name = str(dt)[6:]
            print(f'roi_align R={num} B={batch} {name}: kernel {ms:.4f} ms, '
                  f'bound {bound:.4f} ms ({touched} distinct pixels)')
            if dt == torch.float32:
                row.update(ms_f32=ms, bound_ms_f32=bound)
            else:
                row.update({'ms' + key: ms, 'bound_ms' + key: bound})
                if num == 2000:
                    row['max_abs_err'] = err
                    row['host_ms'] = host_ms(kernel)
                    print(f'roi_align R=2000 bf16: the wrapper\'s host time '
                          f'{row["host_ms"]:.4f} ms per call; an event loop '
                          f'of calls {cuda_ms(kernel):.4f} ms')
                    plain_ms = cuda_ms(lambda: ra.roi_align_pyramid_plain(
                        feats, rois, lvls, (7, 7), strides, 2, True),
                        iters=5)
                    print(f'roi_align R=2000 bf16: plain {plain_ms:.4f} ms')
    return ok, dict(
        name='roi_align', route='cuda', source='arfe_tpu_torch/csrc/roi_align.cu',
        replaces='arfe_tpu/ops/pallas_roi_align.py:339',
        max_abs_err=row.pop('max_abs_err'), ms=row.pop('ms'),
        plain_ms=plain_ms, bound_ms=row.pop('bound_ms'), bound_by='bytes',
        library_ms=None, **row)


def _shifted_levels(gen, rois, num_shifted):
    """Scale-mapped levels, the first ``num_shifted`` moved by -1, 0 or +1."""
    from arfe_tpu_torch.ops import roi_align as ra
    lvls = ra.map_roi_levels(rois, 4, 56)
    shift = torch.randint(-1, 2, lvls.shape, generator=gen, device='cuda')
    shift[num_shifted:] = 0
    return torch.clamp(lvls + shift.to(torch.int32), 0, 3).to(torch.int32)


def check_roi_align_bwd(gen):
    """Kernel C vs ``roi_align_backward_plain`` at the bs2 training shape:
    f32 cotangent (R = 2 x 512 sampled RoIs, 7, 7, 256) into 4 f32 levels of
    (2, 800/s, 1344/s, 256); then the gradient through ``roi_align_pyramid``
    (kernels B and C) over f32 and bf16 levels against the plain versions."""
    from arfe_tpu_torch.ops import roi_align as ra
    dev = 'cuda'
    strides = (4, 8, 16, 32)
    rois = _test_rois(gen, 1024, 2, dev)
    lvls = _shifted_levels(gen, rois, 512)
    shapes = [(2, H // s, W // s, 256) for s in strides]
    g = torch.randn((1024, 7, 7, 256), generator=gen, device=dev)
    # the f32 atomics add in another order on every run: each pixel within
    # 1e-5 of the sum of its terms' magnitudes (the plain backward of |g|)
    scale = ra.roi_align_backward_plain(g.abs(), rois, lvls, shapes)

    def within(got, want, extra=None):
        ok, err = True, 0.0
        for d, w, s in zip(got, want, scale):
            diff = (d.float() - w.float()).abs()
            allowed = 1e-5 * s + 1e-7
            if extra is not None:
                allowed = allowed + extra * w.float().abs()
            ok = ok and bool((diff <= allowed).all()) \
                and bool(torch.isfinite(d).all())
            err = max(err, diff.max().item())
        return ok, err

    got = ra.roi_align_backward_cuda(g, rois, lvls, shapes)
    want = ra.roi_align_backward_plain(g, rois, lvls, shapes)
    torch.cuda.synchronize()
    ok, err = within(got, want)
    print(f'roi_align_bwd R=1024 B=2 f32: max_abs_err {err:.3e} (tol 1e-5 '
          f'sum|terms| + 1e-7) {"ok" if ok else "FAIL"}')
    rows = [ok]
    for dt in (torch.float32, torch.bfloat16):
        feats = [torch.randn(s, generator=gen, device=dev).to(dt)
                 .requires_grad_() for s in shapes]
        out = ra.roi_align_pyramid(feats, rois, lvls, (7, 7), strides, 2)
        got = torch.autograd.grad(out, feats, g.to(dt))
        if dt == torch.float32:
            ref = ra.roi_align_pyramid_plain(feats, rois, lvls, (7, 7),
                                             strides, 2)
            want = torch.autograd.grad(ref, feats, g)
            ok_dt, err_dt = within(got, want)
            tol = 'as above'
        else:
            # the same f32 sums, rounded to bf16: one bf16 ulp more
            want = ra.roi_align_backward_plain(g.to(dt), rois, lvls, shapes)
            ok_dt, err_dt = within(got, want, 2.0 ** -7)
            tol = 'as above + 2^-7 |ref|'
        ok_dt = ok_dt and all(d.dtype == dt for d in got)
        print(f'roi_align autograd (kernels B, C) {str(dt)[6:]} levels: '
              f'max_abs_err {err_dt:.3e} vs plain ({tol}) '
              f'{"ok" if ok_dt else "FAIL"}')
        rows.append(ok_dt)
    ms = cuda_ms(lambda: ra.roi_align_backward_cuda(g, rois, lvls, shapes),
                 graph=True)
    plain_ms = cuda_ms(lambda: ra.roi_align_backward_plain(g, rois, lvls,
                                                           shapes), iters=5)
    touched = _touched_pixels(shapes, rois, lvls, strides)
    pixels = sum(b * h * w for b, h, w, _ in shapes)
    # the function reads the cotangent once and writes each f32 level once
    nbytes = (g.numel() + pixels * 256) * 4
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    # the kernel writes each level once by its zero fill; its atomic adds
    # then read and write every touched pixel at least once more
    extra = 2 * touched * 256 * 4
    print(f'roi_align_bwd R=1024 f32: kernel {ms:.4f} ms (zero fill '
          f'included), plain {plain_ms:.4f} ms, bound {bound:.4f} ms '
          f'({nbytes / 1e6:.1f} MB; {touched} distinct pixels of '
          f'{pixels}; the atomic adds\' read and write of them {extra / 1e6:.1f}'
          f' MB more, {extra / HBM_BYTES_PER_S * 1e3:.4f} ms)')
    zero_ms = cuda_ms(lambda: [torch.zeros(s, device=dev) for s in shapes],
                      graph=True)
    print(f'roi_align_bwd: of its time, the zero fill of the f32 levels alone '
          f'{zero_ms:.4f} ms')
    step_ms, step_bound = _bf16_backward_ms(g, rois, lvls, shapes)
    return all(rows), dict(
        name='roi_align_bwd', route='cuda',
        source='arfe_tpu_torch/csrc/roi_align_bwd.cu',
        replaces='arfe_tpu/ops/pallas_roi_align.py:759',
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by='bytes', library_ms=None, zero_fill_ms=zero_ms,
        backward_bf16_ms=step_ms,
        backward_bf16_bound_ms=step_bound)


def _bf16_backward_ms(g, rois, lvls, shapes):
    """What a bf16 training step pays for the RoIAlign gradient:
    ``RoIAlignFunction.backward`` at bf16 levels (the bf16 cotangent cast to
    f32, the zero fill, kernel C, each level's gradient cast to bf16), timed
    by graph replay beside its bound (the bf16 cotangent read once, the bf16
    level gradients written once)."""
    from types import SimpleNamespace

    from arfe_tpu_torch.ops import roi_align as ra
    ctx = SimpleNamespace(
        saved_tensors=(rois, lvls), args=((7, 7), (4, 8, 16, 32), 2, True),
        levels=[(torch.Size(s), torch.bfloat16) for s in shapes])
    g16 = g.to(torch.bfloat16)
    ms = cuda_ms(lambda: ra.RoIAlignFunction.backward(ctx, g16), graph=True)
    pixels = sum(b * h * w for b, h, w, _ in shapes)
    bound = (g.numel() + pixels * shapes[0][3]) * 2 / HBM_BYTES_PER_S * 1e3
    print(f'roi_align backward at bf16 levels (RoIAlignFunction.backward: '
          f'casts, zero fill, kernel C) R={rois.shape[0]}: {ms:.4f} ms, '
          f'bound {bound:.4f} ms')
    return ms, bound


def check_roi_align_bwd_step(args):
    """Kernel C on the cotangent, RoIs and levels of the first bf16 training
    step (bs2: 2 x 512 sampled RoIs, the positives clustered around the
    ground truth, where the adds contend), against the plain version and
    timed beside its bound."""
    from arfe_tpu_torch.ops import roi_align as ra
    g, rois, lvls, shapes = args
    got = ra.roi_align_backward_cuda(g, rois, lvls, shapes)
    want = ra.roi_align_backward_plain(g, rois, lvls, shapes)
    scale = ra.roi_align_backward_plain(g.abs(), rois, lvls, shapes)
    torch.cuda.synchronize()
    ok, err = True, 0.0
    for d, w, s in zip(got, want, scale):
        diff = (d - w).abs()
        ok = ok and bool((diff <= 1e-5 * s + 1e-7).all()) \
            and bool(torch.isfinite(d).all())
        err = max(err, diff.max().item())
    ms = cuda_ms(lambda: ra.roi_align_backward_cuda(g, rois, lvls, shapes),
                 graph=True)
    pixels = sum(b * h * w for b, h, w, _ in shapes)
    bound = (g.numel() + pixels * g.shape[-1]) * 4 / HBM_BYTES_PER_S * 1e3
    touched = _touched_pixels(shapes, rois, lvls)
    per_level = torch.bincount(lvls.long(), minlength=4).tolist()
    print(f'roi_align_bwd on a training step\'s RoIs R={rois.shape[0]} '
          f'(per level {per_level}, {touched} distinct pixels): max_abs_err '
          f'{err:.3e} (tol 1e-5 sum|terms| + 1e-7) {"ok" if ok else "FAIL"}; '
          f'kernel {ms:.4f} ms, bound {bound:.4f} ms')
    step_ms, step_bound = _bf16_backward_ms(g, rois, lvls, shapes)
    return ok, dict(ms_step_rois=ms, bound_ms_step_rois=bound,
                    backward_bf16_ms_step_rois=step_ms,
                    backward_bf16_bound_ms_step_rois=step_bound)


def check_attention_grad(gen):
    """That ``fused_softmax_attention`` (forward: kernel A; backward: the
    VJP of ``attention_plain``, which recomputes the plain forward and never
    reads kernel A's output) gives the plain version's gradients at the bs2
    training shape (2, 4200, 256): a check that the gradient exists, not an
    agreement of kernels (``check_attention`` holds kernel A). Also the
    backward's time."""
    from arfe_tpu_torch.ops import fused_attention as fa
    ok = True
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn((2, 4200, 256), generator=gen, device='cuda')
                   .to(dt).requires_grad_() for _ in range(3))
        g = torch.randn((2, 4200, 256), generator=gen, device='cuda')
        out = fa.fused_softmax_attention(q, k, v)
        got = torch.autograd.grad(out, (q, k, v), g, retain_graph=True)
        want = torch.autograd.grad(fa.attention_plain(q, k, v), (q, k, v), g)
        err = max((d.float() - w.float()).abs().max().item()
                  / w.float().abs().max().item() for d, w in zip(got, want))
        good = err <= 1e-6 and all(d.dtype == dt for d in got) \
            and all(bool(torch.isfinite(d).all()) for d in got)
        ok = ok and good
        print(f'attention gradient exists (kernel A forward, plain VJP) '
              f'B=2 N=4200 {str(dt)[6:]}: max rel err against the plain '
              f'autograd {err:.3e} (tol 1e-6) '
              f'{"ok" if good else "FAIL"}')
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), g,
                                                 retain_graph=True), iters=5)
    print(f'attention backward (plain VJP) B=2 N=4200 bf16: {bwd_ms:.4f} ms')
    return ok, bwd_ms


def check_kernels():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f'allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, '
          f'cudnn {torch.backends.cudnn.allow_tf32}')
    gen = torch.Generator(device='cuda').manual_seed(0)
    ok_a, row_a = check_attention(gen)
    ok_b, row_b = check_roi_align(gen)
    ok_c, row_c = check_roi_align_bwd(gen)
    ok_g, row_a['backward_plain_vjp_ms'] = check_attention_grad(gen)
    return ok_a and ok_b and ok_c and ok_g, [row_a, row_b, row_c]


# --------------------------------------------------------------------------
# phase 3: serve the flagship at full width
# --------------------------------------------------------------------------

def build_detector():
    """The flagship on the card with seeded random weights; the NonLocal
    ``conv_out`` (zero at init) is made nonzero so the attention reaches the
    outputs."""
    from arfe_tpu_torch.apis import init_detector
    t0 = time.time()
    model = init_detector(FLAGSHIP_CFG)
    gen = torch.Generator(device='cuda').manual_seed(1)
    with torch.no_grad():
        w = model.neck[1].refine.conv_out.conv.weight
        w.copy_(torch.randn(w.shape, generator=gen, device='cuda') * 0.01)
    torch.cuda.synchronize()
    print(f'init_detector: {time.time() - t0:.1f} s, '
          f'{sum(p.numel() for p in model.parameters())} parameters')
    return model


def serve(model):
    """Four bs1 and two bs2 bf16 requests and two bs1 f32 requests at
    800x1344 (random images scaled as bench.py:221 feeds them). Returns the kernel
    launches of the run, and whether every request launched both kernels
    and gave finite detections of the contract's shape."""
    from arfe_tpu_torch.ops import fused_attention as fa
    from arfe_tpu_torch.ops import roi_align as ra
    gen = torch.Generator(device='cuda').manual_seed(2)
    # the first request of a shape or dtype also pays one-time set-up
    # (cuDNN algorithm choice, lazy module loading): serve each twice
    requests = [(1, torch.bfloat16)] * 4 + [(2, torch.bfloat16)] * 2 \
        + [(1, torch.float32)] * 2
    ok = True
    fa.launches = ra.launches = 0
    for i, (b, dt) in enumerate(requests):
        img = (torch.randn((b, H, W, 3), generator=gen, device='cuda')
               * 0.2).to(dt)
        shapes = torch.tensor([IMG_SHAPE] * b, device='cuda')
        scales = torch.ones((b, 4), device='cuda')
        a0, r0 = fa.launches, ra.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets, labels, valid = model.simple_test(img, shapes, scales,
                                                rescale=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        da, dr = fa.launches - a0, ra.launches - r0
        good = (dets.shape == (b, 100, 5) and labels.shape == (b, 100)
                and bool(torch.isfinite(dets).all()) and da > 0 and dr > 0)
        ok = ok and good
        print(f'request {i}: bs{b} {str(dt)[6:]} {ms:.2f} ms, '
              f'{int(valid.sum())} detections, launches attention {da} '
              f'roi_align {dr} {"ok" if good else "FAIL"}')
    return {'fused_attention': fa.launches, 'roi_align': ra.launches}, ok


# --------------------------------------------------------------------------
# phase 4: the served detector against its plain path on the CPU
# --------------------------------------------------------------------------

def reference_check(model):
    """Same weights, same f32 image (1, 320, 480, 3): features within 1e-4
    of their scale, and every CPU detection scoring >= 0.1 matched on the
    card by one of its label with IoU > 0.7 and a score within 1e-2."""
    from arfe_tpu_torch.apis import init_detector
    from arfe_tpu_torch.core.bbox import bbox_overlaps
    cpu = init_detector(FLAGSHIP_CFG, device='cpu')
    cpu.load_state_dict(model.state_dict())
    img = torch.randn((1, 320, 480, 3),
                      generator=torch.Generator().manual_seed(3)) * 0.2
    shapes, scales = torch.tensor([[320.0, 470.0]]), torch.ones(1, 4)
    with torch.no_grad():
        errs = [((g.cpu() - c).abs().max() / c.abs().max()).item()
                for g, c in zip(model.extract_feat(img.cuda()),
                                cpu.extract_feat(img))]
    want = cpu.simple_test(img, shapes, scales)
    got = [t.cpu() for t in model.simple_test(img.cuda(), shapes.cuda(),
                                              scales.cuda())]
    keep = want[2][0] & (want[0][0, :, 4] >= 0.1)
    wd, wl = want[0][0][keep], want[1][0][keep]
    gd, gl = got[0][0][got[2][0]], got[1][0][got[2][0]]
    close = (bbox_overlaps(wd[:, :4], gd[:, :4]) > 0.7) \
        & (wl[:, None] == gl[None]) \
        & ((wd[:, None, 4] - gd[None, :, 4]).abs() < 1e-2)
    matched = int(close.any(dim=1).sum())
    ok = max(errs) <= 1e-4 and len(wd) > 0 and matched == len(wd)
    print(f'reference (CPU plain path, 320x480 f32): feature rel err '
          f'{max(errs):.2e} (tol 1e-4), {matched}/{len(wd)} detections '
          f'matched, {int(got[2].sum())} on the card '
          f'{"ok" if ok else "FAIL"}')
    return ok


# --------------------------------------------------------------------------
# phase 5: train the flagship at full width
# --------------------------------------------------------------------------

def train():
    """Four bs2 bf16 steps and one bs2 f32 step at 800x1344. Returns the
    model, its parameters before the first step, the kernel launches of the
    run, kernel C's arguments in the first step, and whether every step
    gave
    finite losses and launched all three kernels, the frozen parameters
    stayed without a gradient, and every trainable tensor moved, but for
    those whose gradient was exactly 0 in every step (named)."""
    from arfe_tpu_torch.ops import fused_attention as fa
    from arfe_tpu_torch.ops import roi_align as ra
    from arfe_tpu_torch.train import make_train_step
    t0 = time.time()
    model, opt, scheduler, frozen = bench.build_trainer()
    step = make_train_step(model, opt, scheduler)
    batches = {dt: bench.synthetic_batch(2, dtype=dt)
               for dt in (torch.bfloat16, torch.float32)}
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    trainable = [k for k in before if not any(k.startswith(f)
                                              for f in frozen)]
    params = dict(model.named_parameters())
    had_grad = dict.fromkeys(trainable, False)
    torch.cuda.synchronize()
    print(f'build_trainer: {time.time() - t0:.1f} s, frozen {frozen}')
    # the RPN's sampled anchors at the coarsest level (stride 64, last in
    # the anchor table), the only ones whose loss reaches that level
    rpn = model.rpn_head
    top_stride = rpn.anchor_generator.strides[-1]
    n_top = rpn.num_anchors * -(-H // top_stride[1]) * -(-W // top_stride[0])
    targets, sampled = rpn._targets, {}

    def keep_weights(*args, **kwargs):
        out = targets(*args, **kwargs)
        sampled['weights'] = out[1]
        return out
    rpn._targets = keep_weights
    # kernel C's cotangent, RoIs and levels in the first step, for timing
    kernel_c, step_args = ra.roi_align_backward_cuda, []

    def keep_args(g, rois, lvls, shapes, *args, **kwargs):
        if not step_args:
            step_args.extend((g.clone(), rois.clone(), lvls.clone(),
                              [tuple(s) for s in shapes]))
        return kernel_c(g, rois, lvls, shapes, *args, **kwargs)
    ra.roi_align_backward_cuda = keep_args
    gen = torch.Generator(device='cuda').manual_seed(4)
    ok = True
    fa.launches = ra.launches = ra.bwd_launches = 0
    for i, dt in enumerate([torch.bfloat16] * 4 + [torch.float32]):
        counts = (fa.launches, ra.launches, ra.bwd_launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = step(batches[dt], gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        logs = {k: v.item() for k, v in logs.items()}
        grew = [n - c for n, c in zip(
            (fa.launches, ra.launches, ra.bwd_launches), counts)]
        nonzero = torch.stack([params[k].grad.ne(0).any()
                               if params[k].grad is not None
                               else torch.tensor(False, device='cuda')
                               for k in trainable]).tolist()
        had_grad = {k: had_grad[k] or nz for k, nz in zip(trainable,
                                                          nonzero)}
        top = (sampled['weights'][:, -n_top:] > 0).sum(-1).tolist()
        good = all(np.isfinite(v) for v in logs.values()) \
            and all(n > 0 for n in grew)
        ok = ok and good
        print(f'train step {i}: bs2 {str(dt)[6:]} {ms:.2f} ms, '
              + ', '.join(f'{k} {v:.5f}' for k, v in logs.items())
              + f', launches attention {grew[0]} roi_align {grew[1]} '
              f'roi_align_bwd {grew[2]}, RPN anchors sampled at stride '
              f'{top_stride[0]} {top} {"ok" if good else "FAIL"}')
    del rpn._targets
    ra.roi_align_backward_cuda = kernel_c
    launches = {'fused_attention': fa.launches, 'roi_align': ra.launches,
                'roi_align_bwd': ra.bwd_launches}
    frozen_moved = [k for k in before if k not in had_grad and (
        not torch.equal(params[k], before[k]) or params[k].grad is not None)]
    no_grad = [k for k in trainable if params[k].grad is None
               or not bool(torch.isfinite(params[k].grad).all())]
    unchanged = [k for k in trainable if torch.equal(params[k], before[k])]
    zero_grad = [k for k in trainable if not had_grad[k]]
    stuck = [k for k in unchanged if had_grad[k]]
    theta = model.neck[1].refine.theta.conv.weight.grad
    live = theta is not None and float(theta.abs().max()) > 0
    good = not frozen_moved and not no_grad and not stuck and live
    print(f'train parameters: {len(trainable) - len(unchanged)} of '
          f'{len(trainable)} trainable moved; unchanged with a nonzero '
          f'gradient {stuck}; gradient exactly 0 in every step {zero_grad} '
          f'(unchanged: {[k for k in zero_grad if k in unchanged]}); frozen '
          f'moved or with a gradient {frozen_moved[:3]}; without a finite '
          f'gradient {no_grad[:3]}; attention gradient live {live} '
          f'{"ok" if good else "FAIL"}')
    for dt, batch in batches.items():
        print(f'AR-FPN attention-map convs per level in {str(dt)[6:]}, '
              'outputs positive before the ReLU and of those unsaturated by '
              'tanh (reduce_convs: positive, unsaturated; reduce_convs2: the '
              f'same; of): {reduce_conv_activity(model, batch["img"])}')
    return model, before, launches, step_args, ok and good


def reduce_conv_activity(model, img):
    """Per level, for each of the AR-FPN neck's two one-channel
    attention-map convs (``tanh(relu(conv(x)))``): how many outputs are
    positive before the ReLU, and how many of those also leave tanh below 1
    in ``img``'s dtype. Only those pass a gradient to the conv: the ReLU
    passes none where its input is not positive, and tanh's derivative
    ``1 - tanh^2`` is exactly 0 where tanh rounds to 1 (inputs above about
    9 in f32, about 3.5 in bf16)."""
    neck = model.neck[1]
    rows = []
    with torch.no_grad():
        feats = model.neck[0](model.backbone(img.permute(0, 3, 1, 2)))
        for x, b, c in zip(feats, neck.reduce_convs, neck.reduce_convs2):
            row = []
            for m in (b, c):
                z = m.conv(x)
                row += [int((z > 0).sum()),
                        int(((z > 0) & (torch.tanh(z) < 1)).sum())]
            rows.append(tuple(row) + (z.numel(),))
    return rows


# --------------------------------------------------------------------------
# phase 6: a training step on the card against its plain path on the CPU
# --------------------------------------------------------------------------

def train_reference_check(model, start):
    """The trainer's seeded starting weights ``start`` on the card and on
    the CPU; one f32 ``forward_train`` + backward of a (2, 320, 480) batch
    with the same sampling priorities on both, and once more on the CPU with
    one thread (``bench.compare_with_cpu``). The starting weights give the
    check the same input in every run: after the five steps above, whose
    bf16 sums and atomic adds differ from run to run, some parameters'
    gradients can differ by more than the limit between two summation
    orders on the CPU alone. Each loss within ``bench.LOSS_RTOL`` + 4x
    the CPU's own spread, relative; each parameter's largest gradient
    difference within ``bench.GRAD_RTOL`` of its largest |g|, with the CPU's
    spread printed beside it. The kernels' own checks above hold them to f32
    rounding."""
    from arfe_tpu_torch.apis import init_detector
    h, w = 320, 480
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(start[k])
    cpu = init_detector(FLAGSHIP_CFG, device='cpu', train=True)
    cpu.load_state_dict(model.state_dict())
    batch = bench.synthetic_batch(2, h, w, (float(h), float(w)),
                                  torch.float32, seed=6, device='cpu')
    r = bench.compare_with_cpu(model, cpu, batch)
    print(f'train reference (CPU plain path, starting weights, 2x{h}x{w} '
          f'f32, {r["cpu_s"]:.1f} '
          f's on {r["threads"]} CPU threads): loss rel err on the card '
          + ', '.join(f'{k} {v:.2e}' for k, v in r['loss_err'].items())
          + ' (CPU 1 thread vs all: '
          + ', '.join(f'{v:.2e}' for v in r['loss_spread'].values())
          + f'; tol {bench.LOSS_RTOL:g} + 4x); largest gradient difference '
          f'over its parameter\'s largest |g|: {r["grad_err"][0]:.2e} at '
          f'{r["grad_err"][1]} (CPU 1 thread vs all: '
          f'{r["grad_spread"][0]:.2e} at {r["grad_spread"][1]}; tol '
          f'{bench.GRAD_RTOL:g}) over {r["params"]} parameters '
          f'{"ok" if r["ok"] else "FAIL"}')
    print('the same check against kernel C with one level\'s gradient '
          'scaled by 1.03 reads, for levels 0-3: '
          f'{[f"{x:.2e}" for x in level_error_readings(model, batch, r)]} '
          f'(tol {bench.GRAD_RTOL:g})')
    return r['ok']


def level_error_readings(model, batch, r, scale=1.03):
    """What the card-against-CPU gradient check reads when kernel C's
    gradient of one level is off by ``scale``, for each level: the check's
    sensitivity to a level-wide error of a few percent. Informational."""
    from arfe_tpu_torch.ops import roi_align as ra
    kernel = ra.roi_align_backward_cuda
    readings = []
    for lvl in range(4):
        def off(*args, lvl=lvl, **kwargs):
            out = kernel(*args, **kwargs)
            out[lvl] = out[lvl] * scale
            return out
        ra.roi_align_backward_cuda = off
        try:
            got = bench.loss_and_grads(model, batch)
        finally:
            ra.roi_align_backward_cuda = kernel
        readings.append(bench.differences(r['cpu'], got)[1][0])
    return readings


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    name_limit = card()
    print(name_limit)
    build_kernels()
    ok_kernels, rows = check_kernels()
    model = build_detector()
    launches_serve, ok_serve = serve(model)
    ok_ref = reference_check(model)
    del model
    torch.cuda.empty_cache()
    model, start, launches, step_args, ok_train = train()
    ok_step_rois, row_step = check_roi_align_bwd_step(step_args)
    rows[2].update(row_step)
    ok_train_ref = train_reference_check(model, start)
    for row in rows:
        row['launches'] = launches[row['name']]
        row['launches_serve'] = launches_serve.get(row['name'], 0)
    if not (ok_kernels and ok_serve and ok_ref and ok_train
            and ok_step_rois and ok_train_ref):
        print('chip_smoke: a phase failed', file=sys.stderr)
        return 1
    print(json.dumps({'kernels': rows}))
    print(name_limit)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
