"""Where the time of one training step goes, on the card.

    python -m arfe_tpu_torch.tools.profile_train [--batch 2] [--dtype f32]
        [--config PATH]

Trains a detector (by default the flagship Faster R-CNN R50 + AR-FPN; the
AR-RFF flagship is ``configs/arfe/faster_rcnn_r50_arfpn_arrff_1x_coco.py``,
Mask R-CNN ``configs/arfe/mask_rcnn_r50_arfpn_1x_coco.py``, Cascade R-CNN
``configs/arfe/cascade_rcnn_r50_arfpn_1x_coco.py``, RetinaNet
``configs/arfe/retinanet_r50_arfpn_1x_coco.py``, Libra R-CNN + ARFE
``configs/libra_rcnn/libra_faster_rcnn_r{50,101}_fpn_1x_coco.py``, Libra
RetinaNet ``configs/libra_rcnn/libra_retinanet_r50_fpn_1x_coco.py``, Faster
R-CNN + OHEM ``configs/faster_rcnn/faster_rcnn_r50_fpn_ohem_1x_coco.py``,
and the caffe, ResNeXt, C4 and Cascade Mask configs that ``train.bench``
names: ``CAFFE_CFG``, ``LIBRA_X101_CFG``, ``C4_MASK_CFG``,
``CASCADE_MASK_CFG``) at 800x1344 in bf16 (or f32: ``--dtype f32``) with seeded random weights,
the bench's synthetic batch (8 gt boxes of 30-80 px per image, and random
28 x 28 gt mask crops for a mask head, ``bench.py:170-188``) and its SGD
schedule (``bench.py:163-168``), both
from ``arfe_tpu_torch.train.bench`` as in ``chip_smoke.py``, and prints,
over five steps after two warm-up steps:

- the wall time per step and of its stages (forward + losses, backward,
  optimizer update), each closed by a device synchronisation;
- the device's busy time per step and its idle share, from
  ``torch.profiler`` (the union of the kernels' intervals);
- the kernels that take the most device time, and the peak device memory.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import time

import torch

from ..train import bench, parse_losses
from .profile_serve import ITERS, _busy_us


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--batch', type=int, default=2)
    ap.add_argument('--dtype', choices=('bf16', 'f32'), default='bf16')
    ap.add_argument('--config', default=bench.FLAGSHIP_CFG)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_train: no CUDA device')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    model, opt, scheduler, _ = bench.build_trainer(args.config)
    print(f'config {os.path.relpath(args.config)}')
    gen = torch.Generator(device='cuda').manual_seed(0)
    b = args.batch
    batch = bench.synthetic_batch(b, dtype=torch.bfloat16
                                  if args.dtype == 'bf16' else torch.float32,
                                  masks=model.with_mask)

    def forward():
        return parse_losses(model.forward_train(
            batch['img'], batch['img_shape'], batch['gt_bboxes'],
            batch['gt_valid'], batch['gt_labels'], gen,
            gt_mask_crops=batch.get('gt_mask_crops')))

    def staged():
        """One step, stage by stage; returns each stage's wall ms."""
        times = []

        def timed(fn):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            return out

        total, _ = timed(forward)
        opt.zero_grad(set_to_none=True)
        timed(total.backward)
        timed(opt.step)
        scheduler.step()
        return times

    for _ in range(2):
        staged()
    torch.cuda.reset_peak_memory_stats()
    stage_ms = [staged() for _ in range(ITERS)]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            total, _ = forward()
            opt.zero_grad(set_to_none=True)
            total.backward()
            opt.step()
            scheduler.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us(kernels)
    n = ITERS
    names = ('forward + losses', 'backward', 'optimizer')
    for i, name in enumerate(names):
        ms = sorted(s[i] for s in stage_ms)[n // 2]
        print(f'stage {name}: median {ms:.2f} ms wall')
    print(f'step staged: median {sorted(sum(s) for s in stage_ms)[n // 2]:.2f}'
          f' ms wall; peak memory '
          f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB')
    print(f'step bs{b} {args.dtype}: {wall_us / n / 1e3:.2f} ms wall under the '
          f'profiler, device busy {busy / n / 1e3:.2f} ms, idle share '
          f'{1 - busy / wall_us:.3f}, {len(kernels) / n:.0f} kernels')
    totals = {}
    for e in kernels:
        totals[e.name] = totals.get(e.name, 0.0) + e.device_time
    for name, us in sorted(totals.items(), key=lambda kv: -kv[1])[:15]:
        print(f'  {us / n / 1e3:8.3f} ms  {name[:100]}')


if __name__ == '__main__':
    main()
