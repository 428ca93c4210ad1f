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
   the attention and the RoIAlign forward kernels once each.
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
7. Serves the AR-RFF flagship (config #4,
   ``configs/arfe/faster_rcnn_r50_arfpn_arrff_1x_coco.py``) at full width:
   two bs1 and two bs2 requests in bf16 and two bs1 in f32. Each request
   must launch kernel A once and kernel B exactly once, over its 3P triple
   RoIs [ori, lw, lh]; then checks it against the CPU as in 4.
8. Holds kernel B against its plain version on the triple RoIs, levels and
   features of the first bs1 and bs2 requests (R = 3000, 6000) in bf16 and
   f32, times both, and prints how many RoIs reach past the image and how
   they spread over the levels.
9. Trains AR-RFF at full width, bs2: two bf16 steps and one f32. Each step
   launches A, B and C once; the frozen stem and layer1 stay; the fusion
   convs (``hh_conv``, ``wh_conv``, ``final_conv``) move. Holds kernel C
   against its plain version on the first step's cotangent and triple RoIs
   (R = 3072) and times both; then a training step against the CPU as in 6.
10. Serves the "+fac" detector
    (``configs/arfe/faster_rcnn_r50_arfpn_fac_1x_coco.py``): two bs1 bf16
    requests, then against the CPU as in 4.
11. Trains "+fac": two bs2 bf16 steps with a finite ``loss_multi_cls``,
    then a training step against the CPU as in 6.
12. Evaluates AR-RFF (the port config
    ``arfe_tpu_torch/configs/faster_rcnn_r50_arfpn_arrff_1x_coco.py``) on
    a synthetic COCO set of 8 PNGs at COCO's shapes, written under
    ``build/eval_coco``, through the test CLI's functions (dataset, test
    pipeline, loader with the config's 2 workers, ``single_device_test``,
    ``evaluate``) at (1333, 800) on the card, bf16 and f32: every image
    must launch kernels A and B once each; the loader's detections must
    equal ``inference_detector``'s on the same files; A and B are held
    against their plain versions on the arguments of the first real image
    of two padded shapes (and timed on the first); the card's f32 stats
    must be within 1e-3 of the CPU's plain path at (667, 400), ground truth
    seeded from the CPU's detections. Prints whether PIL imports, the host
    pipeline's time per image, images per second, each request's time on
    the card's clock and, under the profiler, the device's idle share.

Prints each phase's wall seconds and the total, one JSON line of kernel
numbers (``launches`` counts the flagship's training run,
``launches_serve`` its serving run, ``launches_{arrff,fac}_{serve,train}``
those of AR-RFF and "+fac", ``launches_arrff_eval`` the two timed
evaluation runs; the ``_arrff_r*`` keys are kernels B and C at AR-RFF's
shapes, the ``_eval_*`` keys A and B on a real image's arguments), then the
card's name and power limit, and as the last line ``{"ok": true, "device":
{...}}``. Exits non-zero, with no result line, if there is no CUDA device or
any phase fails.
"""
from __future__ import annotations

import contextlib
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


def _roi_align_agrees(got, ref, rois, lvls, what):
    """Whether kernel B's output is within its tolerance of the plain
    version's (printed), and the largest difference."""
    d = (got.float() - ref.float()).abs()
    err = d.max().item()
    # f32: the same f32 arithmetic up to FMA contraction in the sum.
    # bf16: both sum the same bf16 inputs in f32; a value near a rounding
    # boundary may round to the neighbour, one bf16 ulp (2^-7 relative).
    if got.dtype == torch.float32:
        allowed, tol = torch.full_like(d, 1e-5), '1e-5'
    else:
        allowed, tol = 2.0 ** -7 * ref.float().abs() + 1e-6, \
            '2^-7 |ref| + 1e-6'
    good = bool((d <= allowed).all()) and bool(torch.isfinite(got).all())
    print(f'roi_align {what} {str(got.dtype)[6:]}: max_abs_err {err:.3e} '
          f'(tol {tol}) {"ok" if good else "FAIL"}')
    if not good:
        worst = int((d - allowed).flatten().argmax())
        r = worst // d[0].numel()
        print(f'  worst at roi {r} {rois[r].tolist()} level {int(lvls[r])}: '
              f'got {got.flatten()[worst].item()} ref '
              f'{ref.flatten()[worst].item()}')
    return good, err


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
        good, err = _roi_align_agrees(got, ref, rois, lvls,
                                      f'R={num} B={batch}')
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


def check_roi_align_bwd_step(args, key='_step_rois', plain=False):
    """Kernel C on the cotangent, RoIs and levels of the first bf16 training
    step (bs2: 2 x 512 sampled RoIs, the positives clustered around the
    ground truth, where the adds contend; three times as many in AR-RFF),
    against the plain version and timed beside its bound (and the plain
    version's time with ``plain``). The row's keys end in ``key``."""
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
    row = {'max_abs_err': err, 'ms': ms, 'bound_ms': bound,
           'backward_bf16_ms': step_ms, 'backward_bf16_bound_ms': step_bound}
    if plain:
        row['plain_ms'] = cuda_ms(lambda: ra.roi_align_backward_plain(
            g, rois, lvls, shapes), iters=5)
        print(f'roi_align_bwd R={rois.shape[0]}: plain {row["plain_ms"]:.4f}'
              ' ms')
    return ok, {k + key: v for k, v in row.items()}


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

def build_detector(cfg=FLAGSHIP_CFG, cls_scale=None):
    """A detector on the card with seeded random weights; the NonLocal
    ``conv_out`` (zero at init) is made nonzero so the attention reaches the
    outputs. With ``cls_scale`` the classifier is scaled by it, and
    ``conv_out`` is drawn on the CPU, so that the weights do not depend on
    the device's generator."""
    from arfe_tpu_torch.apis import init_detector
    t0 = time.time()
    model = init_detector(cfg)
    dev = 'cuda' if cls_scale is None else 'cpu'
    gen = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        w = model.neck[1].refine.conv_out.conv.weight
        w.copy_(torch.randn(w.shape, generator=gen, device=dev) * 0.01)
        if cls_scale is not None:
            model.roi_head.bbox_head.fc_cls.weight.mul_(cls_scale)
    torch.cuda.synchronize()
    print(f'init_detector: {time.time() - t0:.1f} s, '
          f'{sum(p.numel() for p in model.parameters())} parameters')
    return model


def serve(model, requests):
    """The ``(batch, dtype)`` requests at 800x1344 (random images scaled as
    bench.py:221 feeds them; the first request of a shape or dtype also
    pays one-time set-up, such as cuDNN's algorithm choice, so each comes
    twice). Returns the kernel launches of the run, whether every request
    launched kernel A once and kernel B exactly once (one extraction of all
    its RoIs) and gave finite detections of the contract's shape, and
    kernel B's arguments in the first request of each (batch, dtype)."""
    from arfe_tpu_torch.ops import fused_attention as fa
    from arfe_tpu_torch.ops import roi_align as ra
    kernel_b, args = ra.roi_align_cuda, {}
    gen = torch.Generator(device='cuda').manual_seed(2)
    ok = True
    fa.launches = ra.launches = 0
    for i, (b, dt) in enumerate(requests):
        def keep_args(feats, rois, lvls, *rest, key=(b, dt), **kwargs):
            args.setdefault(key, (feats, rois.clone(), lvls.clone()))
            return kernel_b(feats, rois, lvls, *rest, **kwargs)
        ra.roi_align_cuda = keep_args
        img = (torch.randn((b, H, W, 3), generator=gen, device='cuda')
               * 0.2).to(dt)
        shapes = torch.tensor([IMG_SHAPE] * b, device='cuda')
        scales = torch.ones((b, 4), device='cuda')
        a0, r0 = fa.launches, ra.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            dets, labels, valid = model.simple_test(img, shapes, scales,
                                                    rescale=True)
            torch.cuda.synchronize()
        finally:
            ra.roi_align_cuda = kernel_b
        ms = (time.perf_counter() - t0) * 1e3
        da, dr = fa.launches - a0, ra.launches - r0
        good = (dets.shape == (b, 100, 5) and labels.shape == (b, 100)
                and bool(torch.isfinite(dets).all()) and da == 1 and dr == 1)
        ok = ok and good
        print(f'request {i}: bs{b} {str(dt)[6:]} {ms:.2f} ms, '
              f'{int(valid.sum())} detections, launches attention {da} '
              f'roi_align {dr} over {args[b, dt][1].shape[0]} RoIs '
              f'{"ok" if good else "FAIL"}')
    return {'fused_attention': fa.launches, 'roi_align': ra.launches}, ok, \
        args


# --------------------------------------------------------------------------
# phase 4: the served detector against its plain path on the CPU
# --------------------------------------------------------------------------

def reference_check(model, cfg=FLAGSHIP_CFG):
    """Same weights, same f32 image (1, 320, 480, 3): features within 1e-4
    of their scale, and every CPU detection scoring >= 0.1 matched on the
    card by one of its label with IoU > 0.7 (a box of zero area: within 1
    px on every side) and a score within 1e-2."""
    from arfe_tpu_torch.apis import init_detector
    from arfe_tpu_torch.core.bbox import bbox_overlaps
    cpu = init_detector(cfg, device='cpu')
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
    # a box of zero area (a proposal clamped flat against the image's
    # border) has IoU 0 with every box, itself too: it is matched by a card
    # box within 1 px on every side instead
    flat = (wd[:, 2] <= wd[:, 0]) | (wd[:, 3] <= wd[:, 1])
    near = (wd[:, None, :4] - gd[None, :, :4]).abs().amax(dim=-1) <= 1.0
    overlap = torch.where(flat[:, None], near,
                          bbox_overlaps(wd[:, :4], gd[:, :4]) > 0.7)
    close = overlap & (wl[:, None] == gl[None]) \
        & ((wd[:, None, 4] - gd[None, :, 4]).abs() < 1e-2)
    matched = int(close.any(dim=1).sum())
    ok = max(errs) <= 1e-4 and len(wd) > 0 and matched == len(wd)
    print(f'reference (CPU plain path, 320x480 f32): feature rel err '
          f'{max(errs):.2e} (tol 1e-4), {matched}/{len(wd)} detections '
          f'matched ({int(flat.sum())} of zero area), {int(got[2].sum())} '
          f'on the card (lowest score '
          f'{gd[:, 4].min().item() if len(gd) else float("nan"):.4f}) '
          f'{"ok" if ok else "FAIL"}')
    for i in torch.nonzero(~close.any(dim=1)).flatten().tolist():
        print(f'  unmatched: label {int(wl[i])} score {wd[i, 4]:.4f} box '
              f'{[round(x, 2) for x in wd[i, :4].tolist()]}')
    return ok


# --------------------------------------------------------------------------
# phase 5: train the flagship at full width
# --------------------------------------------------------------------------

def train(cfg=FLAGSHIP_CFG, dtypes=(torch.bfloat16,) * 4 + (torch.float32,),
          must_move=()):
    """Bs2 training steps at 800x1344 of the ``cfg`` detector, one per entry
    of ``dtypes``. Returns the model, its parameters before the first step,
    the kernel launches of the run, kernel C's arguments in the first step,
    and whether every step gave finite losses (a "+fac" head's
    ``loss_multi_cls`` among them) and launched kernels A, B and C once
    each, the frozen parameters stayed without a gradient, every trainable
    tensor moved whose gradient was, in some step, large enough for the
    step to move it in f32 (the others are named: those with a gradient
    exactly 0 in every step, and those whose gradient the warm-up learning
    rate scales below rounding), and every tensor of the bbox head's
    ``must_move`` modules moved."""
    from arfe_tpu_torch.ops import fused_attention as fa
    from arfe_tpu_torch.ops import roi_align as ra
    from arfe_tpu_torch.train import make_train_step
    t0 = time.time()
    model, opt, scheduler, frozen = bench.build_trainer(cfg)
    step = make_train_step(model, opt, scheduler)
    batches = {dt: bench.synthetic_batch(2, dtype=dt) for dt in set(dtypes)}
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    trainable = [k for k in before if not any(k.startswith(f)
                                              for f in frozen)]
    params = dict(model.named_parameters())
    had_grad = dict.fromkeys(trainable, False)
    # a step moves every entry of a tensor whose largest |lr g| passes 2^-20
    # of its largest |p|: 16 ulps of f32 at that magnitude and more at any
    # smaller one (the weight decay, 1e-4 p, is far smaller than that g)
    movable = dict.fromkeys(trainable, False)
    p_max = torch.stack([before[k].abs().max() for k in trainable])
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
    try:
        for i, dt in enumerate(dtypes):
            counts = (fa.launches, ra.launches, ra.bwd_launches)
            lr = opt.param_groups[0]['lr']
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logs = step(batches[dt], gen)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            logs = {k: v.item() for k, v in logs.items()}
            grew = [n - c for n, c in zip(
                (fa.launches, ra.launches, ra.bwd_launches), counts)]
            g_max = torch.stack([params[k].grad.abs().max()
                                 if params[k].grad is not None
                                 else torch.zeros((), device='cuda')
                                 for k in trainable])
            nonzero = (g_max > 0).tolist()
            big = (lr * g_max > 2.0 ** -20 * p_max).tolist()
            had_grad = {k: had_grad[k] or nz for k, nz in zip(trainable,
                                                              nonzero)}
            movable = {k: movable[k] or b for k, b in zip(trainable, big)}
            top = (sampled['weights'][:, -n_top:] > 0).sum(-1).tolist()
            good = all(np.isfinite(v) for v in logs.values()) \
                and grew == [1, 1, 1] and ('loss_multi_cls' in logs
                                           or not model.roi_head
                                           .with_multi_cls)
            ok = ok and good
            print(f'train step {i}: bs2 {str(dt)[6:]} {ms:.2f} ms, '
                  + ', '.join(f'{k} {v:.5f}' for k, v in logs.items())
                  + f', launches attention {grew[0]} roi_align {grew[1]} '
                  f'roi_align_bwd {grew[2]} (over {step_args[1].shape[0]} '
                  f'RoIs), RPN anchors sampled at stride {top_stride[0]} '
                  f'{top} {"ok" if good else "FAIL"}')
    finally:
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
    small_grad = [k for k in unchanged if had_grad[k] and not movable[k]]
    stuck = [k for k in unchanged if movable[k]]
    mine = [k for k in params if any(k.startswith(f'roi_head.bbox_head.{m}.')
                                     for m in must_move)]
    mine_stuck = [k for k in mine if k in unchanged]
    theta = model.neck[1].refine.theta.conv.weight.grad
    live = theta is not None and float(theta.abs().max()) > 0
    good = not frozen_moved and not no_grad and not stuck and live \
        and not mine_stuck and len(mine) >= 2 * len(must_move)
    print(f'train parameters: {len(trainable) - len(unchanged)} of '
          f'{len(trainable)} trainable moved; unchanged with a gradient '
          f'large enough to move them {stuck}; unchanged, the gradient too '
          f'small for the learning rate {small_grad}; gradient exactly 0 in '
          f'every step {zero_grad} (unchanged: '
          f'{[k for k in zero_grad if k in unchanged]}); frozen '
          f'moved or with a gradient {frozen_moved[:3]}; without a finite '
          f'gradient {no_grad[:3]}; attention gradient live {live}; of '
          f'{must_move} {len(mine) - len(mine_stuck)} of {len(mine)} tensors '
          f'moved {"ok" if good else "FAIL"}')
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

def train_reference_check(model, start, cfg=FLAGSHIP_CFG, readings=True):
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
    rounding. With ``readings``, also what the check reads for a 3% error
    of kernel C on one level."""
    from arfe_tpu_torch.apis import init_detector
    h, w = 320, 480
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(start[k])
    cpu = init_detector(cfg, device='cpu', train=True)
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
    if readings:
        print('the same check against kernel C with one level\'s gradient '
              'scaled by 1.03 reads, for levels 0-3: '
              f'{[f"{x:.2e}" for x in level_error_readings(model, batch, r)]}'
              f' (tol {bench.GRAD_RTOL:g})')
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


# --------------------------------------------------------------------------
# phases 7-11: the AR-RFF flagship (config #4) and the "+fac" detector
# --------------------------------------------------------------------------

# At random weights the AR-RFF and "+fac" heads' class logits reach the
# hundreds: nearly every score rounds to 1 and the 100-detection cut falls
# among ties, whose order the card and the CPU need not share. Their served
# classifiers are scaled so that the scores spread below the cut (at
# 320x480 on the CPU: 29 and 18 detections score >= 0.1, the 100th 0.075
# and 0.082).
CLS_SCALE = {'arrff': 0.1, 'fac': 0.006}


def _roi_census(rois, lvls, what):
    """How many of the RoIs reach past the image's content (x2 beyond its
    width, y2 beyond its height) and past the levels' padded extent, and
    how the original third and the whole set spread over the levels."""
    r = rois.shape[0] // 3
    h, w = IMG_SHAPE
    past = [int((rois[k * r:(k + 1) * r, 3] > w).sum()
                + (rois[k * r:(k + 1) * r, 4] > h).sum()) for k in range(3)]
    padded = int(((rois[:, 3] > W) | (rois[:, 4] > H)).sum())
    print(f'{what}: {rois.shape[0]} RoIs [ori, lw, lh]; x2 > {w:g} or y2 > '
          f'{h:g} (counted per side) in each third {past}; past the padded '
          f'{W}x{H} {padded}; per level, the originals '
          f'{torch.bincount(lvls[:r].long(), minlength=4).tolist()}, all '
          f'{torch.bincount(lvls.long(), minlength=4).tolist()}')


def check_roi_align_arrff(args):
    """Kernel B against ``roi_align_pyramid_plain`` on the 3P RoIs, levels
    and features of the first bs1 and bs2 AR-RFF requests (R = 3000, 6000),
    in bf16 and f32 (the bs2 levels cast to f32; bs1's from the f32
    request), each timed by graph replay beside its bound and the plain
    version's time."""
    from arfe_tpu_torch.ops import roi_align as ra
    strides = (4, 8, 16, 32)
    ok, row = True, {}
    for b in (1, 2):
        for dt in (torch.bfloat16, torch.float32):
            feats, rois, lvls = args.get((b, dt)) or args[b, torch.bfloat16]
            feats = [f.to(dt) for f in feats]
            num = rois.shape[0]
            if dt == torch.bfloat16:
                _roi_census(rois, lvls, f'AR-RFF bs{b} request')

            def kernel():
                return ra.roi_align_cuda(feats, rois, lvls, (7, 7), strides,
                                         2, True)
            got = kernel()
            ref = ra.roi_align_pyramid_plain(feats, rois, lvls, (7, 7),
                                             strides, 2, True)
            torch.cuda.synchronize()
            good, err = _roi_align_agrees(got, ref, rois, lvls,
                                          f'R={num} B={b} (AR-RFF)')
            del got, ref
            ok = ok and good
            ms = cuda_ms(kernel, graph=True)
            plain_ms = cuda_ms(lambda: ra.roi_align_pyramid_plain(
                feats, rois, lvls, (7, 7), strides, 2, True), iters=5)
            bound, touched = _roi_align_bound(feats, rois, lvls, strides)
            print(f'roi_align R={num} B={b} {str(dt)[6:]} (AR-RFF): kernel '
                  f'{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} '
                  f'ms ({touched} distinct pixels)')
            key = f'_arrff_r{num}' + ('_f32' if dt == torch.float32 else '')
            row.update({'max_abs_err' + key: err, 'ms' + key: ms,
                        'plain_ms' + key: plain_ms, 'bound_ms' + key: bound})
    return ok, row


def arfe(name, requests, train_dtypes, must_move):
    """Serve the ``name`` detector, check it against the CPU, train it, and
    check a training step against the CPU; for AR-RFF also kernels B and C
    at its shapes. Returns each check's result, the serving and training
    runs' launches, and the AR-RFF kernel rows."""
    cfg = bench.ARFE_CFGS[name]
    results, rows = {}, [{}, {}]
    with phase(f'{name}: serve'):
        model = build_detector(cfg, CLS_SCALE[name])
        launches_serve, results['serve'], args = serve(model, requests)
    with phase(f'{name}: card against CPU'):
        results['reference'] = reference_check(model, cfg)
    del model
    torch.cuda.empty_cache()
    if name == 'arrff':
        with phase('arrff: kernel B at R = 3000, 6000'):
            results['kernel_b'], rows[0] = check_roi_align_arrff(args)
    del args
    with phase(f'{name}: train'):
        model, start, launches_train, step_args, results['train'] = \
            train(cfg, train_dtypes, must_move)
    if name == 'arrff':
        with phase('arrff: kernel C at R = 3072'):
            results['kernel_c'], rows[1] = check_roi_align_bwd_step(
                step_args, key='_arrff_r3072', plain=True)
            _roi_census(step_args[1], step_args[2], 'AR-RFF training step')
    del step_args
    with phase(f'{name}: training step, card against CPU'):
        results['train_reference'] = train_reference_check(
            model, start, cfg, readings=False)
    del model
    torch.cuda.empty_cache()
    return results, launches_serve, launches_train, rows


# --------------------------------------------------------------------------
# phase 12: AR-RFF evaluated on a synthetic COCO set through the test CLI's
# functions: image files -> test pipeline -> loader -> single_device_test
# -> CocoDataset.evaluate
# --------------------------------------------------------------------------

PORT_CFG = 'arfe_tpu_torch/configs/faster_rcnn_r50_arfpn_arrff_1x_coco.py'
EVAL_ROOT = 'build/eval_coco'
# (h, w) of COCO val images: padded at (1333, 800) to 800x1088, 1088x800,
# 800x1216 and 1216x800
EVAL_SIZES = [(480, 640), (640, 480), (427, 640), (375, 500), (640, 427),
              (333, 500), (424, 640), (480, 640)]
# the CPU's plain path runs the full-width detector at this scale
CPU_SCALE = (667, 400)
STATS = ('bbox_mAP', 'bbox_AP50', 'bbox_AP75', 'bbox_APs', 'bbox_APm',
         'bbox_APl')


def _eval_config(scale=(1333, 800), workers=None):
    """The AR-RFF port config on the synthetic set at ``scale``."""
    from arfe_tpu_torch.config import Config
    cfg = Config.fromfile(PORT_CFG)
    cfg.data.test.update(ann_file=f'{EVAL_ROOT}/ann.json',
                         img_prefix=f'{EVAL_ROOT}/imgs')
    cfg.data.test.pipeline[1].img_scale = scale
    if workers is not None:
        cfg.data.workers_per_gpu = workers
    return cfg


class RequestLog:
    """Wraps ``model.simple_test``: each request's kernel launches, its
    span on the card's clock (CUDA events) and its end on the host's, and
    the arguments of kernels A and B in the first request of each padded
    shape and dtype."""

    def __init__(self, model):
        from arfe_tpu_torch.ops import fused_attention as fa
        from arfe_tpu_torch.ops import roi_align as ra
        self.model, self.fa, self.ra = model, fa, ra
        self.simple_test = model.simple_test
        self.kernel_a, self.kernel_b = fa.fused_attention_cuda, \
            ra.roi_align_cuda
        self.args, self.requests = {}, []

    def __enter__(self):
        self.model.simple_test = self._request
        return self

    def __exit__(self, *exc):
        del self.model.simple_test
        self.fa.fused_attention_cuda = self.kernel_a
        self.ra.roi_align_cuda = self.kernel_b

    def _request(self, img, *args, **kwargs):
        fa, ra = self.fa, self.ra
        key = (tuple(img.shape[1:3]), img.dtype)
        keep = self.args.setdefault(key, {}) if key not in self.args \
            else None

        def kernel_a(q, k, v, *rest):
            if keep is not None:
                keep.setdefault('a', (q.clone(), k.clone(), v.clone()))
            return self.kernel_a(q, k, v, *rest)

        def kernel_b(feats, rois, lvls, *rest, **kw):
            if keep is not None:
                keep.setdefault('b', ([f.clone() for f in feats],
                                      rois.clone(), lvls.clone()))
            return self.kernel_b(feats, rois, lvls, *rest, **kw)
        fa.fused_attention_cuda, ra.roi_align_cuda = kernel_a, kernel_b
        counts = (fa.launches, ra.launches)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = self.simple_test(img, *args, **kwargs)
        end.record()
        torch.cuda.synchronize()
        self.requests.append(dict(
            shape=key[0], dtype=img.dtype, end=time.perf_counter(),
            card_ms=start.elapsed_time(end),
            launches=(fa.launches - counts[0], ra.launches - counts[1])))
        return out


def _flat(per_class):
    return [(float(box[4]), c, box[:4]) for c, boxes in enumerate(per_class)
            for box in boxes]


def _box_iou(a, b):
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(x2 - x1, 0) * max(y2 - y1, 0)
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return inter / max(union, 1e-10)


def _unmatched(ref, got):
    """The reference detections that no unused detection of ``got`` matches
    by tests/test_e2e_parity_arfe.py:345-366's rule (same label, IoU > 0.7,
    score within 1e-2), a box of zero area by its coordinates within 1 px."""
    used, missing = set(), []
    for sc, lab, box in ref:
        flat = box[2] <= box[0] or box[3] <= box[1]
        for j, (gsc, glab, gbox) in enumerate(got):
            near = (abs(np.asarray(box) - gbox).max() <= 1.0 if flat
                    else _box_iou(box, gbox) > 0.7)
            if j not in used and glab == lab and near \
                    and abs(gsc - sc) < 1e-2:
                used.add(j)
                break
        else:
            missing.append((round(sc, 4), lab,
                            [round(float(x), 1) for x in box]))
    return missing


def _check_eval_kernels(log, dtype, row):
    """Kernels A and B against their plain versions on the arguments of the
    first request of two padded shapes (a landscape and a portrait image),
    in ``dtype``; the first shape's also timed beside its bound, the plain
    version's time and SDPA's. Adds the numbers to ``row`` (A's, B's)."""
    from arfe_tpu_torch.ops import fused_attention as fa
    from arfe_tpu_torch.ops import roi_align as ra
    shapes = [s for s, dt in log.args if dt == dtype][:2]
    ok, name = True, str(dtype)[6:]
    for i, shape in enumerate(shapes):
        args = log.args[shape, dtype]
        q, k, v = args['a']
        got, ref = fa.fused_attention_cuda(q, k, v), fa.attention_plain(q, k,
                                                                        v)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        b, n, c = q.shape
        good = bool(torch.isfinite(got).all())
        if dtype == torch.float32:
            # the plain version's own f32 error on real features (|v| ~ 10)
            # reaches the 1e-4 of phase 2: the kernel is held to 1e-4 of the
            # exact (f64) result, and to the plain version within 1e-4 plus
            # the plain version's own distance from the exact result
            exact = torch.softmax(q.double() @ k.double().transpose(-1, -2),
                                  -1) @ v.double()
            err_exact = (got.double() - exact).abs().max().item()
            plain_exact = (ref.double() - exact).abs().max().item()
            del exact
            tol = 1e-4 + plain_exact
            good = good and err <= tol and err_exact <= 1e-4
            detail = (f'; against f64: kernel {err_exact:.3e} (tol 1e-4), '
                      f'plain {plain_exact:.3e}')
        else:
            tol = 2.0 ** -8 * v.float().abs().max().item()
            good = good and err <= tol
            detail = ''
        print(f'eval attention {shape[0]}x{shape[1]} (N={n}) {name}, max |v| '
              f'{v.float().abs().max().item():.2f}: max_abs_err {err:.3e} '
              f'against plain (tol {tol:.3e}){detail} '
              f'{"ok" if good else "FAIL"}')
        feats, rois, lvls = args['b']
        got_b = ra.roi_align_cuda(feats, rois, lvls, (7, 7), (4, 8, 16, 32),
                                  2, True)
        ref_b = ra.roi_align_pyramid_plain(feats, rois, lvls, (7, 7),
                                           (4, 8, 16, 32), 2, True)
        torch.cuda.synchronize()
        good_b, err_b = _roi_align_agrees(
            got_b, ref_b, rois, lvls, f'R={rois.shape[0]} {shape[0]}x'
            f'{shape[1]} (eval)')
        ok = ok and good and good_b
        del got, ref, got_b, ref_b
        if i:
            continue
        suffix = f'_eval_{shape[0]}x{shape[1]}' + (
            '_f32' if dtype == torch.float32 else '')
        ms = cuda_ms(lambda: fa.fused_attention_cuda(q, k, v), graph=True)
        plain_ms = cuda_ms(lambda: fa.attention_plain(q, k, v))
        q4, k4, v4 = (t[:, None] for t in (q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, scale=1.0), graph=True)
        bound, by = _attention_bound(b, n, c, dtype)
        print(f'eval attention N={n} {name}: kernel {ms:.4f} ms, plain '
              f'{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound:.4f} '
              f'ms ({by})')
        row[0].update({'max_abs_err' + suffix: err, 'ms' + suffix: ms,
                       'plain_ms' + suffix: plain_ms,
                       'library_ms' + suffix: lib_ms,
                       'bound_ms' + suffix: bound, 'n' + suffix: n})

        def kernel():
            return ra.roi_align_cuda(feats, rois, lvls, (7, 7),
                                     (4, 8, 16, 32), 2, True)
        ms_b = cuda_ms(kernel, graph=True)
        plain_b = cuda_ms(lambda: ra.roi_align_pyramid_plain(
            feats, rois, lvls, (7, 7), (4, 8, 16, 32), 2, True), iters=5)
        bound_b, touched = _roi_align_bound(feats, rois, lvls)
        print(f'eval roi_align R={rois.shape[0]} {name}: kernel {ms_b:.4f} '
              f'ms, plain {plain_b:.4f} ms, bound {bound_b:.4f} ms '
              f'({touched} distinct pixels)')
        row[1].update({'max_abs_err' + suffix: err_b, 'ms' + suffix: ms_b,
                       'plain_ms' + suffix: plain_b,
                       'bound_ms' + suffix: bound_b})
    return ok and len(shapes) == 2


def _timed_run(model, loader, dtype, log):
    """``single_device_test`` over the set; returns the results, the wall
    seconds, and the images per second after the first request (the loader's
    worker start-up excluded)."""
    from arfe_tpu_torch.apis import single_device_test
    first = len(log.requests)
    t0 = time.perf_counter()
    results = single_device_test(model, loader, show_progress=False,
                                 dtype=dtype)
    wall = time.perf_counter() - t0
    ends = [r['end'] for r in log.requests[first:]]
    steady = (len(ends) - 1) / (ends[-1] - ends[0])
    return results, wall, steady


def evaluate_arrff():
    """Writes the synthetic set, evaluates AR-RFF on the card at (1333, 800)
    in bf16 and f32 with the test CLI's functions, and checks: one launch
    of A and of B per image; the loader's detections equal to
    ``inference_detector``'s on the same files; A and B against their plain
    versions on real images' arguments; the card's f32 stats against the
    CPU's plain path at ``CPU_SCALE``, with ground truth seeded from the
    CPU's detections. Returns whether all held, the launches of the timed
    runs, and the rows' additions for A and B."""
    from arfe_tpu_torch.apis import inference_detector, single_device_test
    from arfe_tpu_torch.data import synthetic
    from arfe_tpu_torch.ops import fused_attention as fa
    from arfe_tpu_torch.ops import roi_align as ra
    from arfe_tpu_torch.tools.profile_serve import _busy_us
    from arfe_tpu_torch.tools.test import build_test_loader
    try:
        import PIL
        print(f'PIL imports: yes, {PIL.__version__} (JPEG is read)')
    except ImportError:
        print('PIL imports: no (only PNG is read)')
    t0 = time.time()
    images = synthetic.write_images(EVAL_ROOT, EVAL_SIZES, seed=7)
    synthetic.write_annotations(f'{EVAL_ROOT}/ann.json', images)
    print(f'eval set: {len(images)} PNGs at {EVAL_SIZES} written in '
          f'{time.time() - t0:.1f} s')
    cfg = _eval_config()
    model = build_detector(cfg, CLS_SCALE['arrff'])
    dataset, loader = build_test_loader(cfg)
    bf, f32, rows, ok = torch.bfloat16, torch.float32, [{}, {}], True
    n = len(images)
    t0 = time.perf_counter()
    for i in range(n):
        dataset[i]
    host_ms = (time.perf_counter() - t0) / n * 1e3
    print(f'eval host pipeline (read, resize, normalize, pad) in the main '
          f'process: {host_ms:.2f} ms per image')
    runs = {}
    with RequestLog(model) as log:
        for dt in (bf, f32):          # first runs: one-time set-up per shape
            runs[dt, 'warm'] = _timed_run(model, loader, dt, log)[0]
        # ground truth from the bf16 detections, so that the timed runs'
        # evaluation does the work of a real one
        synthetic.write_annotations(
            f'{EVAL_ROOT}/ann.json', images,
            synthetic.seed_ground_truth(images, runs[bf, 'warm']))
        dataset, loader = build_test_loader(cfg)
        first = len(log.requests)
        fa.launches = ra.launches = ra.bwd_launches = 0
        for dt in (bf, f32):
            results, wall, steady = _timed_run(model, loader, dt, log)
            t1 = time.perf_counter()
            stats = dataset.evaluate(results, metric='bbox')
            eval_s = time.perf_counter() - t1
            reqs = [r for r in log.requests[first:] if r['dtype'] == dt]
            card = sorted(r['card_ms'] for r in reqs)
            print(f'eval {str(dt)[6:]} bs1 (1333, 800), {n} images, 2 loader '
                  f'workers: {n / (wall + eval_s):.2f} images/s with the '
                  f'evaluation ({wall:.3f} s the loader and the requests, '
                  f'{eval_s:.3f} s evaluate), {steady:.2f} images/s after '
                  f'the first request; a request on the card\'s clock: '
                  f'median {card[len(card) // 2]:.2f} ms, '
                  f'{min(card):.2f}-{max(card):.2f}; bbox_mAP '
                  f'{stats["bbox_mAP"]:.4f}')
            runs[dt] = results
            rows[0][f'eval_images_per_s_{str(dt)[6:]}'] = n / (wall + eval_s)
        launches = {'fused_attention': fa.launches, 'roi_align': ra.launches,
                    'roi_align_bwd': ra.bwd_launches}
        per_request = [r['launches'] for r in log.requests[first:]]
    good = all(p == (1, 1) for p in per_request) \
        and launches == {'fused_attention': 2 * n, 'roi_align': 2 * n,
                         'roi_align_bwd': 0}
    print(f'eval launches per request (attention, roi_align): '
          f'{sorted(set(per_request))}, over the two runs {launches} '
          f'{"ok" if good else "FAIL"}')
    ok = ok and good
    # the loader path's detections against inference_detector's
    for dt in (bf, f32):
        same = True
        for i in range(3):
            path = f'{EVAL_ROOT}/imgs/{images[i]["file_name"]}'
            single = inference_detector(model, path, dtype=dt)
            same = same and all(np.array_equal(a, b) for a, b in
                                zip(single, runs[dt][i]))
        print(f'eval {str(dt)[6:]}: the loader\'s detections of 3 images '
              f'equal inference_detector\'s {"ok" if same else "FAIL"}')
        ok = ok and same
    with phase('arrff eval: kernels A and B on real images'):
        for dt in (bf, f32):
            ok = _check_eval_kernels(log, dt, rows) and ok
    del log
    # the card's busy share of an evaluation run
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    loader0 = build_test_loader(_eval_config(workers=0))[1]
    for workers, ldr in ((0, loader0), (2, loader)):
        t1 = time.perf_counter()
        single_device_test(model, ldr, show_progress=False, dtype=bf)
        wall = time.perf_counter() - t1
        print(f'eval bf16 with {workers} loader workers: '
              f'{n / wall:.2f} images/s ({wall:.3f} s, worker start-up '
              f'included)')
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        single_device_test(model, loader0, show_progress=False, dtype=bf)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t1) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us(kernels)
    print(f'eval bf16, 0 workers, under the profiler: {wall_us / n / 1e3:.2f}'
          f' ms per image, device busy {busy / n / 1e3:.2f} ms, idle share '
          f'{1 - busy / wall_us:.3f}')
    with phase('arrff eval: card f32 against the CPU'):
        ok = eval_reference_check(model, images) and ok
    del model
    torch.cuda.empty_cache()
    return ok, launches, rows


def eval_reference_check(model, images):
    """The same weights and files on the CPU's plain path and on the card in
    f32, at ``CPU_SCALE``; ground truth seeded from the CPU's detections.
    The six bbox stats within 1e-3; detections the rule does not match are
    printed."""
    from arfe_tpu_torch.apis import init_detector, single_device_test
    from arfe_tpu_torch.data import synthetic
    from arfe_tpu_torch.tools.test import build_test_loader
    cfg = _eval_config(CPU_SCALE)
    cpu = init_detector(cfg, device='cpu')
    cpu.load_state_dict(model.state_dict())
    t0 = time.time()
    want = single_device_test(cpu, build_test_loader(cfg)[1],
                              show_progress=False)
    cpu_s = time.time() - t0
    got = single_device_test(model, build_test_loader(cfg)[1],
                             show_progress=False, dtype=torch.float32)
    synthetic.write_annotations(f'{EVAL_ROOT}/ann.json', images,
                                synthetic.seed_ground_truth(images, want))
    dataset = build_test_loader(cfg)[0]
    s_cpu = dataset.evaluate(want, metric='bbox')
    s_card = dataset.evaluate(got, metric='bbox')
    diff = max(abs(s_cpu[k] - s_card[k]) for k in STATS)
    ok = diff <= 1e-3 and 0.05 < s_cpu['bbox_mAP'] < 0.999
    print(f'eval card f32 against the CPU plain path at {CPU_SCALE} '
          f'({cpu_s:.1f} s on the CPU): CPU '
          + ', '.join(f'{k} {s_cpu[k]:.4f}' for k in STATS) + '; card '
          + ', '.join(f'{k} {s_card[k]:.4f}' for k in STATS)
          + f'; largest difference {diff:.2e} (tol 1e-3) '
          f'{"ok" if ok else "FAIL"}')
    for i, (w, g) in enumerate(zip(want, got)):
        missing = _unmatched(_flat(w), _flat(g))
        extra = _unmatched(_flat(g), _flat(w))
        if missing or extra:
            print(f'  image {i}: CPU detections unmatched on the card '
                  f'{missing[:5]}, card detections unmatched on the CPU '
                  f'{extra[:5]} ({len(_flat(w))} and {len(_flat(g))} '
                  'detections)')
    return ok


PHASE_SECONDS = {}


@contextlib.contextmanager
def phase(name):
    """Prints the phase's wall seconds when it ends, and keeps them in
    ``PHASE_SECONDS``."""
    t0 = time.time()
    try:
        yield
    finally:
        PHASE_SECONDS[name] = time.time() - t0
        print(f'phase {name}: {PHASE_SECONDS[name]:.1f} s', flush=True)


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    t0 = time.time()
    name_limit = card()
    print(name_limit)
    with phase('build'):
        build_kernels()
    with phase('kernels'):
        ok_kernels, rows = check_kernels()
    bf, f32 = torch.bfloat16, torch.float32
    with phase('flagship: serve'):
        model = build_detector()
        launches_serve, ok_serve, _ = serve(
            model, [(1, bf)] * 4 + [(2, bf)] * 2 + [(1, f32)] * 2)
    with phase('flagship: card against CPU'):
        ok_ref = reference_check(model)
    del model
    torch.cuda.empty_cache()
    with phase('flagship: train'):
        model, start, launches, step_args, ok_train = train()
    with phase('flagship: kernel C on a step\'s RoIs'):
        ok_step_rois, row_step = check_roi_align_bwd_step(step_args)
    rows[2].update(row_step)
    del step_args
    with phase('flagship: training step, card against CPU'):
        ok_train_ref = train_reference_check(model, start)
    del model
    torch.cuda.empty_cache()
    arrff = arfe('arrff', [(1, bf)] * 2 + [(2, bf)] * 2 + [(1, f32)] * 2,
                 [bf, bf, f32], ('hh_conv', 'wh_conv', 'final_conv'))
    rows[1].update(arrff[3][0])
    rows[2].update(arrff[3][1])
    # at random weights the "+fac" presence logits saturate: its
    # loss_multi_cls reads 1 + tanh(1) and can pass no gradient
    fac = arfe('fac', [(1, bf)] * 2, [bf, bf], ())
    with phase('arrff: evaluate'):
        ok_eval, launches_eval, eval_rows = evaluate_arrff()
    rows[0].update(eval_rows[0])
    rows[1].update(eval_rows[1])
    for row in rows:
        row['launches'] = launches[row['name']]
        row['launches_serve'] = launches_serve.get(row['name'], 0)
        for name, (_, serve_runs, train_runs, _) in (('arrff', arrff),
                                                      ('fac', fac)):
            row[f'launches_{name}_serve'] = serve_runs.get(row['name'], 0)
            row[f'launches_{name}_train'] = train_runs[row['name']]
        row['launches_arrff_eval'] = launches_eval[row['name']]
    failed = [k for k, v in (('kernels', ok_kernels), ('serve', ok_serve),
                             ('reference', ok_ref), ('train', ok_train),
                             ('kernel C on a step', ok_step_rois),
                             ('train reference', ok_train_ref),
                             ('arrff evaluate', ok_eval)) if not v]
    failed += [f'{name} {k}' for name, r in (('arrff', arrff), ('fac', fac))
               for k, v in r[0].items() if not v]
    print(f'phases: {len(PHASE_SECONDS)}, total {time.time() - t0:.1f} s')
    if failed:
        print(f'chip_smoke: phases failed: {failed}', file=sys.stderr)
        return 1
    print(json.dumps({'kernels': rows}))
    print(name_limit)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
