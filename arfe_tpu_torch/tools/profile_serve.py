"""Where the time of one request goes, on the card.

    python -m arfe_tpu_torch.tools.profile_serve [--batch 1] [--config PATH]

Serves a detector (by default the flagship Faster R-CNN R50 + AR-FPN,
``configs/_base_/models/faster_rcnn_r50_arfpn.py``; the AR-RFF flagship is
``configs/arfe/faster_rcnn_r50_arfpn_arrff_1x_coco.py``, Mask R-CNN
``configs/arfe/mask_rcnn_r50_arfpn_1x_coco.py``, whose RoI head stage holds
its mask branch, Cascade R-CNN ``configs/arfe/cascade_rcnn_r50_arfpn_1x_coco.
py``, whose RoI head stage holds its three stages, RetinaNet
``configs/arfe/retinanet_r50_arfpn_1x_coco.py``) at 800x1344 in bf16
with seeded random weights (as ``chip_smoke.py`` does) and prints, over five
requests after two warm-up requests:

- the wall time per request and of its stages (backbone + necks, RPN
  proposals, RoI head; for a single-stage detector backbone + necks, the
  dense head's convs, its decode and NMS), each closed by a device
  synchronisation;
- the device's busy time per request and its idle share, from
  ``torch.profiler`` (the union of the kernels' intervals);
- the kernels that take the most device time.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import time

import torch

ITERS = 5
CFG = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..', '..',
                   'configs', '_base_', 'models', 'faster_rcnn_r50_arfpn.py')


def _busy_us(events):
    """Length of the union of the device kernels' [start, end) intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--batch', type=int, default=1)
    ap.add_argument('--config', default=CFG)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_serve: no CUDA device')
    from arfe_tpu_torch.apis import init_detector
    from arfe_tpu_torch.models.detectors import TwoStageDetector
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    model = init_detector(args.config)
    print(f'config {os.path.relpath(args.config)}')
    gen = torch.Generator(device='cuda').manual_seed(0)
    b = args.batch
    img = (torch.randn((b, 800, 1344, 3), generator=gen, device='cuda')
           * 0.2).to(torch.bfloat16)
    shapes = torch.tensor([[800.0, 1333.0]] * b, device='cuda')
    scales = torch.ones((b, 4), device='cuda')

    two_stage = isinstance(model, TwoStageDetector)

    def staged():
        """One request, stage by stage; returns each stage's wall ms."""
        def timed(fn, *a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            return out

        times = []
        with torch.inference_mode():
            feats = timed(model.extract_feat, img)
            if two_stage:
                props = timed(model.rpn_head.get_proposals, feats, shapes)
                timed(model.roi_head.simple_test, feats, *props, shapes,
                      scales, rescale=True)
            else:
                outs = timed(model.dense_head, feats)
                timed(model.dense_head.get_bboxes, *outs, shapes, scales,
                      rescale=True)
        return times

    for _ in range(2):
        staged()
    stage_ms = [staged() for _ in range(ITERS)]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            model.simple_test(img, shapes, scales, rescale=True)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us(kernels)
    n = ITERS
    names = ('backbone + necks', 'rpn proposals', 'roi head') if two_stage \
        else ('backbone + necks', 'dense head', 'decode + nms')
    for i, name in enumerate(names):
        ms = sorted(s[i] for s in stage_ms)[n // 2]
        print(f'stage {name}: median {ms:.2f} ms wall')
    print(f'request bs{b} bf16: {wall_us / n / 1e3:.2f} ms wall under the '
          f'profiler, device busy {busy / n / 1e3:.2f} ms, idle share '
          f'{1 - busy / wall_us:.3f}, {len(kernels) / n:.0f} kernels')
    totals = {}
    for e in kernels:
        totals[e.name] = totals.get(e.name, 0.0) + e.device_time
    for name, us in sorted(totals.items(), key=lambda kv: -kv[1])[:12]:
        print(f'  {us / n / 1e3:8.3f} ms  {name[:100]}')


if __name__ == '__main__':
    main()
