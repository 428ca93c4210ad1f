"""Smoke run of the PyTorch/CUDA port (``arfe_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

1. Prints the card's name and power limit and builds the CUDA kernels from
   ``arfe_tpu_torch/csrc`` (one ``nvcc`` per source, all at once).
2. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes, in f32 and bf16, and times kernel, plain version and
   (where one exists) the PyTorch library call with CUDA events.
3. Serves the flagship Faster R-CNN R50 + AR-FPN
   (``configs/_base_/models/faster_rcnn_r50_arfpn.py``) at full width on
   ``cuda`` with seeded random weights: four bs1 and two bs2 requests at
   800x1344 in bf16, and two bs1 requests in f32. Every request must launch
   both kernels.
4. Checks the served detector against the same weights on the CPU (plain
   path) on a small image.

Prints one JSON line of kernel numbers, then the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``. Exits non-zero, with no
result line, if there is no CUDA device or any phase fails.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP_CFG = os.path.join(REPO, 'configs', '_base_', 'models',
                            'faster_rcnn_r50_arfpn.py')

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
H, W = 800, 1344            # the bench's padded image (bench.py:28)
IMG_SHAPE = (800.0, 1333.0)  # its content shape (bench.py:90)


def card():
    """The card's ``name, power.limit`` as nvidia-smi reports them."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Mean milliseconds per call of ``fn`` from CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build_kernels():
    from arfe_tpu_torch.ops import cuda_build
    t0 = time.time()
    logs = cuda_build.build(['fused_attention', 'roi_align'])
    print(f'build: {time.time() - t0:.1f} s for {sorted(logs) or "nothing"}')
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line or 'smem' in line:
                print(f'  {name}: {line.strip()}')


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def check_attention(gen):
    """Kernel A vs ``attention_plain`` at AR-FPN's refine shape
    (N = 50*84 = 4200 tokens of the stride-16 level, C = 256, no scale)."""
    from arfe_tpu_torch.ops import fused_attention as fa
    dev = 'cuda'
    rows = []
    cases = [(b, n, dt) for b in (1, 2) for n in (4200, 77)
             for dt in (torch.float32, torch.bfloat16)]
    main = None
    for b, n, dt in cases:
        q, k, v = (torch.randn((b, n, 256), generator=gen, device=dev)
                   .to(dt) for _ in range(3))
        got = fa.fused_attention_cuda(q, k, v)
        ref = fa.attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        # f32: both sum in f32, in another order; logits reach |q||k| ~ 50.
        # bf16: the plain version rounds p to bf16 before PV, the kernel
        # keeps f32, a difference of at most 2^-9 * max|v|; twice that.
        tol = 1e-4 if dt == torch.float32 \
            else 2.0 ** -8 * v.float().abs().max().item()
        ok = bool(torch.isfinite(got).all()) and err <= tol
        print(f'attention B={b} N={n} C=256 {str(dt)[6:]}: max_abs_err '
              f'{err:.3e} (tol {tol:.3e}) {"ok" if ok else "FAIL"}')
        rows.append(ok)
        if (b, n, dt) == (1, 4200, torch.bfloat16):
            main = (q, k, v, err)
    q, k, v, err = main
    b, n, c = q.shape
    ms = cuda_ms(lambda: fa.fused_attention_cuda(q, k, v))
    plain_ms = cuda_ms(lambda: fa.attention_plain(q, k, v))
    q4, k4, v4 = (t[:, None] for t in (q, k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                            scale=1.0))
    flops = 4.0 * b * n * n * c
    nbytes = b * n * c * (3 * q.element_size() + 4)
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    print(f'attention B=1 N=4200 bf16: kernel {ms:.4f} ms, plain '
          f'{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms')
    return all(rows), dict(
        name='fused_attention', route='cuda',
        source='arfe_tpu_torch/csrc/fused_attention.cu',
        replaces='arfe_tpu/ops/pallas_attention.py:102',
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_ops, t_bytes),
        bound_by='operations' if t_ops >= t_bytes else 'bytes',
        library_ms=lib_ms)


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


def check_roi_align(gen):
    """Kernel B vs ``roi_align_pyramid_plain`` at the bs2 serving shape:
    4 levels of (2, 800/s, 1344/s, 256), R = 2 x 1000 proposals."""
    from arfe_tpu_torch.ops import roi_align as ra
    dev = 'cuda'
    strides = (4, 8, 16, 32)
    rois = _test_rois(gen, 2000, 2, dev)
    lvls = ra.map_roi_levels(rois, 4, 56)
    shift = torch.randint(-1, 2, lvls.shape, generator=gen, device=dev)
    shift[:1000] = 0          # half mapped by scale, half shifted by +-1
    lvls = torch.clamp(lvls + shift.to(torch.int32), 0, 3).to(torch.int32)
    rows = []
    main = None
    for dt in (torch.float32, torch.bfloat16):
        feats = [torch.randn((2, H // s, W // s, 256), generator=gen,
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
        ok = bool((d <= allowed).all()) and bool(torch.isfinite(got).all())
        print(f'roi_align R=2000 B=2 {str(dt)[6:]}: max_abs_err {err:.3e} '
              f'(tol {tol}) {"ok" if ok else "FAIL"}')
        if not ok:
            worst = int((d - allowed).flatten().argmax())
            r = worst // d[0].numel()
            print(f'  worst at roi {r} {rois[r].tolist()} level '
                  f'{int(lvls[r])}: got {got.flatten()[worst].item()} ref '
                  f'{ref.flatten()[worst].item()}')
        rows.append(ok)
        if dt == torch.bfloat16:
            main = (feats, err)
    feats, err = main
    ms = cuda_ms(lambda: ra.roi_align_cuda(feats, rois, lvls, (7, 7),
                                           strides, 2, True))
    plain_ms = cuda_ms(lambda: ra.roi_align_pyramid_plain(
        feats, rois, lvls, (7, 7), strides, 2, True), iters=5)
    corners, valid = ra.sample_corners([f.shape[:3] for f in feats], rois,
                                       lvls, (7, 7), strides, 2, True)
    touched = torch.unique(torch.cat([idx[valid] for idx, _ in corners]))
    isz = feats[0].element_size()
    nbytes = touched.numel() * 256 * isz + rois.shape[0] * 49 * 256 * isz
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f'roi_align R=2000 bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} '
          f'ms, bound {bound:.4f} ms ({touched.numel()} distinct pixels)')
    return all(rows), dict(
        name='roi_align', route='cuda', source='arfe_tpu_torch/csrc/roi_align.cu',
        replaces='arfe_tpu/ops/pallas_roi_align.py:339',
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by='bytes', library_ms=None)


def check_kernels():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f'allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, '
          f'cudnn {torch.backends.cudnn.allow_tf32}')
    gen = torch.Generator(device='cuda').manual_seed(0)
    ok_a, row_a = check_attention(gen)
    ok_b, row_b = check_roi_align(gen)
    return ok_a and ok_b, [row_a, row_b]


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


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    name_limit = card()
    print(name_limit)
    build_kernels()
    ok_kernels, rows = check_kernels()
    model = build_detector()
    launches, ok_serve = serve(model)
    ok_ref = reference_check(model)
    for row in rows:
        row['launches'] = launches[row['name']]
    if not (ok_kernels and ok_serve and ok_ref):
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
