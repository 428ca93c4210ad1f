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
   ``cuda`` with seeded random weights: two bs1 and one bs2 request at
   800x1344 in bf16, and one bs1 request in f32. Every request must launch
   the attention and the RoIAlign forward kernels once each.
4. Checks the served detector against the same weights on the CPU (plain
   path) on a small image.
5. Trains the flagship at full width with the bench's SGD schedule and
   synthetic batch (``bench.py:150-185``): two bs2 steps at 800x1344 in
   bf16 and one in f32. Every step must launch all three kernels; the frozen
   stem and layer1 must not move; every other tensor must move, unless its
   gradient was exactly 0 in every step (those are named). Then holds
   kernel C against its plain version on the first step's cotangent, RoIs
   and levels, and times it there.
6. Checks one f32 training step on the card against the same weights (the
   trainer's seeded starting weights), sampling priorities and choice of
   proposals on the CPU (plain path) on a small image: losses and
   gradients.
7. Serves the AR-RFF flagship (config #4,
   ``configs/arfe/faster_rcnn_r50_arfpn_arrff_1x_coco.py``) at full width:
   a bs1 and a bs2 request in bf16 and a bs1 in f32. Each request
   must launch kernel A once and kernel B exactly once, over its 3P triple
   RoIs [ori, lw, lh]; then checks it against the CPU as in 4.
8. Holds kernel B against its plain version on the triple RoIs, levels and
   features of the first bs1 and bs2 requests (R = 3000, 6000) in bf16 and
   f32, times both, and prints how many RoIs reach past the image and how
   they spread over the levels.
9. Trains AR-RFF at full width, bs2: a bf16 step and an f32 one. Each step
   launches A, B and C once; the frozen stem and layer1 stay; the fusion
   convs (``hh_conv``, ``wh_conv``, ``final_conv``) move. Holds kernel C
   against its plain version on the first step's cotangent and triple RoIs
   (R = 3072) and times both; then a training step against the CPU as in 6.
10. Serves the "+fac" detector
    (``configs/arfe/faster_rcnn_r50_arfpn_fac_1x_coco.py``): a bs1 bf16
    request, then against the CPU as in 4.
11. Trains "+fac": a bs2 bf16 step with a finite ``loss_multi_cls``,
    then a training step against the CPU as in 6.
12. Evaluates AR-RFF (the port config
    ``arfe_tpu_torch/configs/faster_rcnn_r50_arfpn_arrff_1x_coco.py``) on
    a synthetic COCO set of 4 PNGs at COCO's shapes, written under
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
13. Trains AR-RFF (the same port config) through the train CLI
    (``tools.train.main``) at full width on a box set of 8 PNGs at COCO's
    two shapes under ``build/train_coco``: bs2 bf16 for 2 epochs of 4
    iterations with validation at epoch 2, then again from a copy of
    ``epoch_1.pth`` with ``--resume-from`` for epoch 2, then the test CLI
    (``tools.test.main``) on ``latest.pth``. Checks that every iteration
    launches A, B and C once (A and B once per validated image), that the
    logged losses are finite and ``train.log.json`` parses, that the
    checkpoints hold the optimizer and scheduler, that the frozen stem and
    layer1 stay and the other parameters move between ``epoch_1.pth`` and
    ``epoch_2.pth``, that the resumed epoch 2 has the uninterrupted run's
    images, flips and LRs and its first iteration's losses, that the test
    CLI gives the six bbox stats and the card's f32 detections with
    ``latest.pth`` match the CPU's plain path's at (667, 400) on the set's
    first two images (one of each aspect), and that the
    validation wrote its line. Prints the seconds per iteration, the
    loader's share, images per second, the idle share under the profiler,
    and the checkpoints' save and load seconds and size.
14. Serves Mask R-CNN + AR-FPN (config #5a,
    ``configs/arfe/mask_rcnn_r50_arfpn_1x_coco.py``) at full width: a bs1
    and a bs2 request in bf16 and a bs1 in f32. Each request launches A
    once and B exactly twice (the boxes' 7 x 7 bins, then the detections'
    14 x 14: every detection slot, padding included) and gives finite mask
    logits (B, 100, 28, 28); then the card against the CPU as in 4, the
    matched detections' mask logits included.
15. Holds kernel B at 14 x 14 against its plain version on the mask RoIs,
    levels and features of the first bs1 and bs2 requests (R = 100, 200),
    bf16 and f32, bit for bit, and times both beside the bound.
16. Trains Mask R-CNN at full width, bs2: a bf16 step and an f32 step
    with the bench's random mask crops. Each step launches A once, B and C
    twice; ``loss_mask`` is finite, the frozen stem and layer1 stay, every
    ``mask_head`` tensor moves. Holds kernel C at 14 x 14 against its plain
    version on the first step's mask cotangent and RoIs (R = 256), times
    both, then a training step against the CPU as in 6 (``loss_mask`` and
    the mask head's gradients among them).
17. Trains Mask R-CNN through the train CLI (the port config
    ``arfe_tpu_torch/configs/mask_rcnn_r50_arfpn_1x_coco.py``: one epoch of
    4 iterations, bs2 bf16, on 8 PNGs of polygon instances under
    ``build/mask_coco``, masks and their fixed crops through the train
    pipeline and collate), then the test CLI on ``latest.pth`` with
    ``--eval bbox segm``: A once, B and C twice per iteration; A once and B
    twice per evaluated image; the twelve stats; the card's f32 bbox and
    segm stats within 1e-3 of the CPU's plain path at (667, 400) on the
    set's first two images, ground truth seeded from the CPU's detections
    and masks, every detection
    matched one for one (phase 13's classifier spread, ``score_thr=0``).
    Prints the host paste's time per image.
18. Serves Cascade R-CNN + AR-FPN (config #5b,
    ``configs/arfe/cascade_rcnn_r50_arfpn_1x_coco.py``) at full width: a
    bs1 and a bs2 request in bf16 and a bs1 in f32. Each request
    launches A once and B exactly three times (one per stage: the RPN's
    proposals, then the boxes each stage regressed); then the card against
    the CPU as in 4.
19. Holds kernel B against its plain version on each stage's RoIs, levels
    and features of the first bs1 and bs2 requests (R = 1000, 2000 a
    stage), bf16 and f32, bit for bit, and times both beside the bound.
20. Trains Cascade R-CNN at full width, bs2: a bf16 step and an f32 one.
    Each step launches A once, B and C three times; the frozen stem and
    layer1 stay; stages 1 and 2's shared FCs and classifiers move. Holds
    kernel C against its plain version on each stage's cotangent and RoIs
    of the first step (R = 1024 a stage, 1e-5) and times it, then a
    training step against the CPU as in 6 (every stage's losses).
21. Trains Cascade R-CNN through the train CLI (the port config
    ``arfe_tpu_torch/configs/cascade_rcnn_r50_arfpn_1x_coco.py``: one epoch
    of 4 iterations, bs2 bf16, 8 box PNGs under ``build/cascade_coco``,
    read without loader workers) and runs the test CLI on ``latest.pth``
    with ``--eval bbox``: A once, B and
    C three times per iteration; A once and B three times per evaluated
    image; the six stats; the card's f32 stats within 1e-3 of the CPU's
    plain path at (667, 400) on the set's first two images, every
    detection matched (phase 13's rule).
22. Serves RetinaNet + AR-FPN (config #2,
    ``configs/arfe/retinanet_r50_arfpn_1x_coco.py``): the requests of 18;
    each launches A once and B never; then the card against the CPU as in
    4, the classifier's weights scaled (``CLS_SCALE``).
23. Holds kernel A against its plain version on the NonLocal refine level
    of the first bs1 and bs2 requests (N = 25 x 42 = 1050 tokens, the
    stride-32 level of five from stride 8), bf16 and f32 (and f64), with the
    split count ``key_splits`` picks and a forced one that leaves splits
    without keys, and times it beside its bound, the plain version and
    SDPA.
24. Trains RetinaNet at full width, bs2: a bf16 step and an f32 one (the
    focal loss over all 201,600 anchors an image). Each step launches A
    once and neither B nor C; the head's last convs and its classifier
    move; then a training step against the CPU as in 6.
25. Trains and evaluates RetinaNet through the CLIs as 21 (the port config
    ``arfe_tpu_torch/configs/retinanet_r50_arfpn_1x_coco.py``, ``build/
    retina_coco``): A once per iteration and per image, no B or C; the card
    against the CPU with the 0.05 threshold kept and the classifier's
    weights scaled up until each image has 10 detections.
26. Serves Libra R-CNN + ARFE (R50,
    ``configs/libra_rcnn/libra_faster_rcnn_r50_fpn_1x_coco.py``: AR-FPN at
    refine level 3, N = 1050): the requests of 18, each A and B once; then
    the card against the CPU as in 4.
27. Holds kernel A at N = 1050 (as 23) and B (bit for bit, as 19) on the
    first bs1 and bs2 Libra requests' arguments.
28. Trains Libra at full width, bs2: a bf16 step and an f32 one with the
    instance-balanced positives, IoU-balanced negatives and balanced L1,
    each step A, B and C once, ``fc_reg`` moving; prints the first step's
    sampling per gt and IoU bin, which must be round robin. Holds kernel C
    on the first step's cotangent (R = 1024, 1e-5); the balanced sampler
    on a skewed assignment on the card against the CPU (equal slots, round
    robin); then a step against the CPU as in 6, with the same draws under
    the balanced ranking.
29. Trains and evaluates Libra through the CLIs as 21 (the config itself,
    whose data section comes through ``_base_``; ``build/libra_coco``).
30. Serves Libra R101 (``libra_faster_rcnn_r101_fpn_1x_coco.py``, each
    residual block's last BatchNorm scale damped by ``R101_DAMP``): two
    bs1 bf16 requests, A and B once each, against the CPU; then a bs2
    bf16 step, A, B and C once, and its peak memory.
31. Serves Libra RetinaNet (``libra_retinanet_r50_fpn_1x_coco.py``: BFP
    at refine level 1 of five levels from stride 8, N = 50 x 84 = 4200):
    A once, no B; against the CPU.
32. Holds kernel A at N = 4200 on BFP's gathered feature of the first bs1
    and bs2 requests, as 23.
33. Trains Libra RetinaNet (balanced L1 at beta 0.11): A once a step, no B
    or C; then a step against the CPU.
34. Trains Faster R-CNN + OHEM (``faster_rcnn_r50_fpn_ohem_1x_coco.py``):
    each step launches no A, B twice (the hard-mining forward over every
    candidate, then the sampled RoIs) and C once (the hard-mining pass
    builds no graph). Holds B on the first step's hard-mining RoIs (R = 2 x
    1016) bit for bit, then a step against the CPU: each candidate's hard
    score held against the CPU's, then all runs ranked by the CPU's.
35. Serves OHEM's detector: no A, B once a request.
36. Serves Faster R-CNN + BFP (``faster_rcnn_r50_fpn_bfp_1x_coco.py``: BFP
    at refine level 2 of P2-P6, N = 4200): A and B once a request; against
    the CPU.
37. Serves Faster R-CNN R50 caffe + FPN (``faster_rcnn_r50_caffe_fpn_1x_
    coco.py``: each stage's stride on its first 1x1 conv) at bs1 and bs2
    bf16 and bs1 f32: no A, B once a request; against the CPU.
38. Trains it (bs2, a bf16 and an f32 step: B and C once each), then a
    step against the CPU; then through the train and test CLIs as 21, on
    8 box PNGs under ``build/caffe_coco`` through its BGR
    ``Normalize(to_rgb=False)`` pipeline: no A, B and C once an iteration,
    B once an evaluated image.
39. Serves Libra R-CNN + ARFE on ResNeXt-101 64x4d (``libra_faster_rcnn_
    x101_64x4d_fpn_1x_coco.py``, its classifier scaled by ``CLS_SCALE``):
    A and B once a request; against the CPU; kernel A at its refine level
    (N = 1050) as 23.
40. Trains it (A, B and C once a step), then a step against the CPU.
41. Serves Mask R-CNN C4 (``mask_rcnn_r50_caffe_c4_1x_coco.py``: a caffe
    ResNet-50 to stage 3, no neck, the RPN and RoIAlign on one stride-16
    level of 1024 channels, the shared ``layer4`` on every RoI): no A, B
    twice a request at 14 x 14 (the proposals, then the detection slots),
    mask logits (B, 100, 14, 14); against the CPU, mask logits included.
42. Holds kernel B on both launches' arguments of the first bs1 and bs2
    requests (R = 1000, 2000 and 100, 200), bf16 and f32, bit for bit.
43. Trains Mask R-CNN C4 (a bf16 and an f32 step: B and C twice, the 2 x
    512 sampled RoIs and the 2 x 128 mask RoIs; the shared head's last
    block, the mask head and the classifier move); kernel C at 1024
    channels on both cotangents of the first step (1e-5); the RPN stage's
    time and memory at the training ``nms_pre`` (12000); a step against
    the CPU with 256 proposals and 64 sampled RoIs an image.
44. Serves Faster R-CNN C4 (``faster_rcnn_r50_caffe_c4_1x_coco.py``): no
    A, B once a request; against the CPU.
45. Serves Cascade Mask R-CNN R50 (``cascade_mask_rcnn_r50_fpn_1x_coco.
    py``): no A, B three times a request, boxes only; against the CPU;
    kernel B on each stage's served RoIs as 19.
46. Trains it (B and C six times a step: each stage's boxes at 7 x 7,
    then its mask RoIs at 14 x 14; every stage's mask head moves); kernel
    B on each stage's mask RoIs of the first step (bit for bit) and kernel
    C on each of its six cotangents (1e-5), keyed by stage; a step against
    the CPU.
47. Serves Mask R-CNN R50 caffe + FPN as mmdet 1.x trained it
    (``mask_rcnn_r50_caffe_fpn_poly_1x_coco_v1.py``: the legacy +1 box
    coder, RoIAlign with ``sample_num=2``): one bs1 request, no A, B
    twice; against the CPU.
48. Serves the RPN alone (``configs/rpn/rpn_r50_fpn_1x_coco.py``) at bs1
    and bs2 bf16 and bs1 f32: no A, no B, 1000 proposals an image; against
    the CPU (each level's candidate logits and regressions within 1e-4 of
    their scale, the card's proposals the plain selection from its own
    candidates: ``bench.selection_faults`` finds none; how many of the
    CPU's the card's lacks printed, a top-k or NMS flip among near-tied
    objectness scores).
49. The proposals' average recall: one f32 request at 800x1344 on the card
    and on the CPU, a COCO set of that image with gts jittered from the
    CPU's proposals, ``CocoDataset.evaluate('proposal_fast')``: each
    ``AR@100/300/1000`` within 1e-6 plus the share of gts that the
    proposals either side's first n lacks could move.
50. Trains the RPN (a bf16 and an f32 step, no kernel; ``rpn_cls`` and
    ``rpn_reg`` move), then a step against the CPU.
51. Serves its C4 form (``rpn_r50_caffe_c4_1x_coco.py``: one stride-16
    level, ``nms_pre`` 12000, 2000 proposals) at bs1 bf16 and f32, and
    against the CPU as 48.
52. Serves FSAF (``configs/fsaf/fsaf_r50_fpn_1x_coco.py``: one square
    anchor a position, the TBLR coder, the ReLU on the box branch; its
    classifier's weights scaled as RetinaNet's): no A, no B; against the
    CPU. Trains it (no kernel; the online level choice's
    ``gt_assign_hist`` printed a step), then a step against the CPU, the
    histogram held exactly.
53-58. Faster R-CNN R50 + FPN with the GIoU loss in the RoI head
    (``faster_rcnn_r50_fpn_giou_1x_coco.py``): served at bs1 and bs2 bf16
    and bs1 f32 (no A, B once a request) and against the CPU; kernel B on
    the first bs1 and bs2 requests' proposals, bit for bit in bf16 and
    f32; trained (a bf16 and an f32 step, B and C once; ``fc_reg`` moves),
    kernel C on the first step's cotangent and RoIs (1e-5); ``IoULoss`` and
    ``BoundedIoULoss`` and their gradients on that step's RoI head inputs
    (the encoded deltas both packages feed the loss), card against CPU; a
    step against the CPU.
59-63. The same for FPNBU (``configs/arfe/faster_rcnn_r50_fpn_bu_1x_coco.
    py``; its ``bu_convs`` and ``compress_convs`` move).
64-68. The same for FPN + FPNRelation (``faster_rcnn_r50_fpn_relation_1x_
    coco.py``).
69-73. The same for FPNCBAM with AR-RFF's head (``configs/mytrain/faster_
    rcnn_r50_fpn_cbam_1x_coco.py``): B once a request over the 3P triple
    RoIs (R = 3000, 6000), once a step over 3072.
74-78. The same for AttRoIs (``faster_rcnn_r50_fpn_att_1x_visdrone.py``,
    80 classes as its config says), a bs2 f32 request too, and against the
    CPU on a batch of two: its cross-RoI attention spans the batch's
    images, so the check compares the same batch.
79. VisDrone "+fac" (``configs/mytrain/faster_rcnn_r50_fpn_multicls_1x_
    visdrone.py``, 12 classes) through the CLIs as 21, its ``data.train``
    a list of two sets of four PNGs (a ``ConcatDataset``) labelled with
    VisDrone's categories under ``build/visdrone_coco``, bs2, the gradient
    clipped at norm 35 (unclipped, the run at random weights reaches NaN):
    B and C once an
    iteration, B once an evaluated image; kernel B on the first evaluated
    image's RoIs bit for bit and C on the first iteration's cotangent
    (1e-5).

Prints each phase's wall seconds and the total, one JSON line of kernel
numbers (``launches`` counts the flagship's training run,
``launches_serve`` its serving run, ``launches_{arrff,fac}_{serve,train}``
those of AR-RFF and "+fac", ``launches_arrff_eval`` the two timed
evaluation runs, ``launches_arrff_trainrun`` the two training runs of
phase 13 with its validation, ``launches_mask_{serve,train,eval}`` those of
phases 14, 16 and 17's test CLI, ``launches_{cascade,retina}_{serve,train,
eval}`` those of phases 18, 20, 21 and 22, 24, 25,
``launches_libra_{serve,train,eval}``, ``launches_libra101_{serve,train}``,
``launches_libra_retina_{serve,train}``, ``launches_ohem_{serve,train}`` and
``launches_bfp_serve`` those of phases 26-36,
``launches_{caffe,libra_x101,c4_mask,c4,cascade_mask,v1}_serve``,
``launches_{caffe,libra_x101,c4_mask,cascade_mask}_train`` and
``launches_caffe_eval`` those of phases 37-47,
``launches_{rpn,fsaf,giou,fpnbu,relation,cbam,att}_{serve,train}``,
``launches_rpn_c4_serve`` and ``launches_visdrone_eval`` those of phases
48-79; the ``_arrff_r*`` keys
are kernels B and C at AR-RFF's shapes, the ``_mask_r*`` keys B and C at 14
x 14 bins, the ``_cascade_s{i}_r*`` keys B and C on cascade stage i's
inputs, the ``_retina_n1050*`` keys A at RetinaNet's refine level, the
``_libra_n1050*``, ``_libra_r*`` keys A, B and C on Libra's arguments, the
``_bfp_n4200*`` keys A at Libra RetinaNet's BFP level, the ``_ohem_r*`` keys
B on OHEM's hard-mining RoIs, the ``_libra_x101_n1050*`` keys A on Libra
X101's refine level, the ``_c4_r*`` and ``_c4_mask_r*`` keys B and C at the
C4 shapes (14 x 14, 1024 channels; the boxes' and the masks' launches), the
``_cascade_mask_s{i}_*`` keys B and C on cascade mask stage i's inputs, the
``_{giou,fpnbu,relation,cbam,att,visdrone}_r*`` keys B and C on those
families' arguments, the ``_eval_*`` keys A and B on a real image's
arguments, the ``train_run_*``
keys phase 13's numbers, ``mask_paste_ms_per_image`` phase 17's), then the
card's name and power limit, and as the last line ``{"ok": true, "device":
{...}}``. Exits non-zero, with no result line, if there is no CUDA device or
any phase fails.
"""
from __future__ import annotations

import contextlib
import copy
import json
import os
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


def _touched_pixels(level_shapes, rois, lvls, strides=(4, 8, 16, 32),
                    out_size=(7, 7)):
    """How many distinct level pixels the RoIs' out_size x 2 x 2 samples
    read."""
    from arfe_tpu_torch.ops import roi_align as ra
    corners, valid = ra.sample_corners([s[:3] for s in level_shapes], rois,
                                       lvls, out_size, strides, 2, True)
    return torch.unique(torch.cat([idx[valid] for idx, _ in corners])).numel()


def _roi_align_bound(feats, rois, lvls, strides=(4, 8, 16, 32),
                     out_size=(7, 7)):
    """Least time of one RoIAlign call, ms: the output written once and the
    distinct feature pixels its samples touch read once, at HBM rate.
    Returns it and the count of those pixels."""
    touched = _touched_pixels([f.shape for f in feats], rois, lvls, strides,
                              out_size)
    c, isz = feats[0].shape[-1], feats[0].element_size()
    nbytes = (touched + rois.shape[0] * out_size[0] * out_size[1]) * c * isz
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


def _level_strides(shapes):
    """The strides of levels of (B, h, w, ...) ``shapes`` of an 800x1344
    image: (4, 8, 16, 32) for an FPN's four, (16,) for a C4 trunk's."""
    return tuple(H // s[1] for s in shapes)


def _bf16_backward_ms(g, rois, lvls, shapes):
    """What a bf16 training step pays for the RoIAlign gradient:
    ``RoIAlignFunction.backward`` at bf16 levels (the bf16 cotangent cast to
    f32, the zero fill, kernel C, each level's gradient cast to bf16), timed
    by graph replay beside its bound (the bf16 cotangent read once, the bf16
    level gradients written once)."""
    from types import SimpleNamespace

    from arfe_tpu_torch.ops import roi_align as ra
    ctx = SimpleNamespace(
        saved_tensors=(rois, lvls),
        args=(tuple(g.shape[1:3]), _level_strides(shapes), 2, True),
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
    out_size, strides = tuple(g.shape[1:3]), _level_strides(shapes)
    got = ra.roi_align_backward_cuda(g, rois, lvls, shapes, out_size, strides)
    want = ra.roi_align_backward_plain(g, rois, lvls, shapes, out_size,
                                       strides)
    scale = ra.roi_align_backward_plain(g.abs(), rois, lvls, shapes,
                                        out_size, strides)
    torch.cuda.synchronize()
    ok, err = True, 0.0
    for d, w, s in zip(got, want, scale):
        diff = (d - w).abs()
        ok = ok and bool((diff <= 1e-5 * s + 1e-7).all()) \
            and bool(torch.isfinite(d).all())
        err = max(err, diff.max().item())
    ms = cuda_ms(lambda: ra.roi_align_backward_cuda(
        g, rois, lvls, shapes, out_size, strides), graph=True)
    pixels = sum(b * h * w for b, h, w, _ in shapes)
    bound = (g.numel() + pixels * g.shape[-1]) * 4 / HBM_BYTES_PER_S * 1e3
    touched = _touched_pixels(shapes, rois, lvls, strides, out_size)
    per_level = torch.bincount(lvls.long(), minlength=len(shapes)).tolist()
    print(f'roi_align_bwd on a training step\'s RoIs R={rois.shape[0]} at '
          f'{out_size[0]} x {out_size[1]} bins, {g.shape[-1]} channels (per '
          f'level {per_level}, '
          f'{touched} distinct pixels): max_abs_err '
          f'{err:.3e} (tol 1e-5 sum|terms| + 1e-7) {"ok" if ok else "FAIL"}; '
          f'kernel {ms:.4f} ms, bound {bound:.4f} ms')
    step_ms, step_bound = _bf16_backward_ms(g, rois, lvls, shapes)
    row = {'max_abs_err': err, 'ms': ms, 'bound_ms': bound,
           'backward_bf16_ms': step_ms, 'backward_bf16_bound_ms': step_bound}
    if plain:
        row['plain_ms'] = cuda_ms(lambda: ra.roi_align_backward_plain(
            g, rois, lvls, shapes, out_size, strides), iters=5)
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
    ``conv_out`` (zero at init; where the neck has one) is made nonzero so
    the attention reaches the outputs. With ``cls_scale`` the weights of
    ``model.classifiers()`` are scaled by it, their biases kept, and
    ``conv_out`` is drawn on the CPU, so that the weights do not depend on
    the device's generator."""
    from arfe_tpu_torch.apis import init_detector
    t0 = time.time()
    model = init_detector(cfg)
    dev = 'cuda' if cls_scale is None else 'cpu'
    gen = torch.Generator(device=dev).manual_seed(1)
    refine = bench.refine_block(model)
    with torch.no_grad():
        if refine is not None:
            w = refine.conv_out.conv.weight
            w.copy_(torch.randn(w.shape, generator=gen, device=dev) * 0.01)
        if cls_scale is not None:
            for layer in model.classifiers():
                layer.weight.mul_(cls_scale)
    torch.cuda.synchronize()
    print(f'init_detector: {time.time() - t0:.1f} s, '
          f'{sum(p.numel() for p in model.parameters())} parameters')
    return model


def serve(model, requests):
    """The ``(batch, dtype)`` requests at 800x1344 (random images scaled as
    bench.py:221 feeds them; the first request of a shape or dtype also
    pays one-time set-up, such as cuDNN's algorithm choice, so each comes
    twice). Returns the kernel launches of the run, whether every request
    launched kernel A once (never without a NonLocal refine in the neck)
    and kernel B exactly ``model.num_extractions``
    times (one extraction of all its RoIs per RoI head stage: a cascade's
    three, a Mask R-CNN's boxes' and its detections', a single-stage
    detector none) and gave finite detections (and, where the model serves
    masks, square mask logits) of the contract's shape, and the kernels'
    arguments in the first request of each (batch, dtype): A's under
    (batch, dtype, 'a'), each B launch's under (batch, dtype, 'launch', j)
    in launch order, B's first under (batch, dtype), and for each 7 x 7
    stage under (batch, dtype, 'stage', i), the first at other bins under
    (batch, dtype, bins)."""
    from arfe_tpu_torch.ops import fused_attention as fa
    from arfe_tpu_torch.ops import roi_align as ra
    kernel_a, kernel_b, args = fa.fused_attention_cuda, ra.roi_align_cuda, {}
    gen = torch.Generator(device='cuda').manual_seed(2)
    ok = True
    with_mask, n_b = model.serves_masks, model.num_extractions
    n_a = int(bench.refine_block(model) is not None)
    fa.launches = ra.launches = 0
    for i, (b, dt) in enumerate(requests):
        stage, order = [0], [0]

        def keep_a(q, k, v, *rest, key=(b, dt, 'a')):
            args.setdefault(key, (q.clone(), k.clone(), v.clone()))
            return kernel_a(q, k, v, *rest)

        def keep_args(feats, rois, lvls, out_size=(7, 7), *rest, key=(b, dt),
                      **kwargs):
            kept = (feats, rois.clone(), lvls.clone())
            args.setdefault(key + ('launch', order[0]), kept)
            args.setdefault(key, kept)
            order[0] += 1
            if tuple(out_size) == (7, 7):
                args.setdefault(key + ('stage', stage[0]), kept)
                stage[0] += 1
            else:
                args.setdefault(key + (out_size[0],), kept)
            return kernel_b(feats, rois, lvls, out_size, *rest, **kwargs)
        fa.fused_attention_cuda, ra.roi_align_cuda = keep_a, keep_args
        img = (torch.randn((b, H, W, 3), generator=gen, device='cuda')
               * 0.2).to(dt)
        shapes = torch.tensor([IMG_SHAPE] * b, device='cuda')
        scales = torch.ones((b, 4), device='cuda')
        a0, r0 = fa.launches, ra.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            out = model.simple_test(img, shapes, scales, rescale=True)
            torch.cuda.synchronize()
        finally:
            fa.fused_attention_cuda, ra.roi_align_cuda = kernel_a, kernel_b
        ms = (time.perf_counter() - t0) * 1e3
        da, dr = fa.launches - a0, ra.launches - r0
        if len(out) == 2:
            # an RPN's proposals and their validity
            dets, valid = out
            n = model.rpn_head.test_cfg['nms_post']
            good = dets.shape == (b, n, 5) and valid.shape == (b, n)
        else:
            dets, labels, valid = out[:3]
            good = (dets.shape == (b, 100, 5) and labels.shape == (b, 100)
                    and len(out) == 3 + with_mask)
        good = good and bool(torch.isfinite(dets).all()) and da == n_a \
            and dr == n_b
        launched = [args[b, dt, 'launch', j] for j in range(order[0])] \
            if (b, dt, 'launch', 0) in args else []
        rois = ' + '.join(
            f'{a[1].shape[0]}' for a in launched) + ' RoIs' \
            if launched else 'no RoIs'
        if with_mask:
            side = out[3].shape[2]
            good = good and out[3].shape == (b, 100, side, side) \
                and bool(torch.isfinite(out[3]).all())
            rois += (f', mask logits {tuple(out[3].shape)} in '
                     f'[{out[3].min().item():.3f}, {out[3].max().item():.3f}]')
        ok = ok and good
        print(f'request {i}: bs{b} {str(dt)[6:]} {ms:.2f} ms, '
              f'{int(valid.sum())} detections, launches attention {da} '
              f'roi_align {dr} over {rois} {"ok" if good else "FAIL"}')
    return {'fused_attention': fa.launches, 'roi_align': ra.launches}, ok, \
        args


# --------------------------------------------------------------------------
# phase 4: the served detector against its plain path on the CPU
# --------------------------------------------------------------------------

def reference_check(model, cfg=FLAGSHIP_CFG, batch=1, proposals=None):
    """Same weights, same f32 images (``batch``, 320, 480, 3; a batch of two
    for a head whose RoIs see each other's, AttRoIs'): features within 1e-4
    of their scale, and every CPU detection scoring >= 0.1 matched on the
    card by one of its label with IoU > 0.7 (a box of zero area: within 1
    px on every side) and a score within 1e-2; for a mask model, each
    matched detection's mask logits (boxes of nonzero area) within 1e-3 of
    the largest |logit| (at least 1) of the CPU's. With ``proposals``, both
    sides serve that many proposals an image (the C4 head runs ResNet's
    ``layer4`` on each: 1.46 GFLOP a RoI on the CPU)."""
    from arfe_tpu_torch.apis import init_detector
    from arfe_tpu_torch.core.bbox import bbox_overlaps
    cpu = init_detector(cfg, device='cpu')
    cpu.load_state_dict(model.state_dict())
    if proposals is None:
        return _reference_check(model, cpu, batch, bbox_overlaps)
    served = model.rpn_head.test_cfg
    for m in (model, cpu):
        m.rpn_head.test_cfg = dict(m.rpn_head.test_cfg, nms_post=proposals,
                                   max_num=proposals)
    try:
        return _reference_check(model, cpu, batch, bbox_overlaps)
    finally:
        model.rpn_head.test_cfg = served


def _reference_check(model, cpu, batch, bbox_overlaps):
    """:func:`reference_check` on the card's ``model`` and the ``cpu``
    copy."""
    img = torch.randn((batch, 320, 480, 3),
                      generator=torch.Generator().manual_seed(3)) * 0.2
    shapes = torch.tensor([[320.0, 470.0], [310.0, 480.0]][:batch])
    scales = torch.ones(batch, 4)
    with torch.no_grad():
        errs = [((g.cpu() - c).abs().max() / c.abs().max()).item()
                for g, c in zip(model.extract_feat(img.cuda()),
                                cpu.extract_feat(img))]
    want = cpu.simple_test(img, shapes, scales)
    got = [t.cpu() for t in model.simple_test(img.cuda(), shapes.cuda(),
                                              scales.cuda())]
    ok = max(errs) <= 1e-4
    for i in range(batch):
        ok = _detections_match(want, got, i, bbox_overlaps) and ok
    print(f'reference (CPU plain path, {batch}x320x480 f32): feature rel err '
          f'{max(errs):.2e} (tol 1e-4) {"ok" if ok else "FAIL"}')
    return ok


def _detections_match(want, got, i, bbox_overlaps):
    """:func:`reference_check`'s rule for image ``i`` of the CPU's and the
    card's ``simple_test`` outputs; prints what it found."""
    keep = want[2][i] & (want[0][i, :, 4] >= 0.1)
    wd, wl = want[0][i][keep], want[1][i][keep]
    gd, gl = got[0][i][got[2][i]], got[1][i][got[2][i]]
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
    ok = len(wd) > 0 and matched == len(wd)
    masks = ''
    if len(want) == 4:
        # the first card detection matching each CPU one, boxes of nonzero
        # area
        wm = want[3][i][keep]
        gm = got[3][i][got[2][i]]
        pairs = [(k, int(torch.nonzero(close[k])[0]))
                 for k in range(len(wd)) if close[k].any() and not flat[k]]
        scale = max(1.0, wm.abs().max().item()) if len(wm) else 1.0
        err = max((float((gm[j] - wm[k]).abs().max()) for k, j in pairs),
                  default=float('inf'))
        ok = ok and len(pairs) > 0 and err <= 1e-3 * scale
        masks = (f'; mask logits of {len(pairs)} matched detections: max '
                 f'abs err {err:.3e} (tol 1e-3 x {scale:.3f}), CPU logits '
                 f'in [{wm.min().item():.3f}, {wm.max().item():.3f}]')
    print(f'reference image {i}: {matched}/{len(wd)} detections '
          f'matched ({int(flat.sum())} of zero area), {int(got[2][i].sum())} '
          f'on the card (lowest score '
          f'{gd[:, 4].min().item() if len(gd) else float("nan"):.4f})'
          f'{masks} {"ok" if ok else "FAIL"}')
    for k in torch.nonzero(~close.any(dim=1)).flatten().tolist():
        print(f'  unmatched: label {int(wl[k])} score {wd[k, 4]:.4f} box '
              f'{[round(x, 2) for x in wd[k, :4].tolist()]}')
    return ok


# --------------------------------------------------------------------------
# phase 5: train the flagship at full width
# --------------------------------------------------------------------------

def train(cfg=FLAGSHIP_CFG, dtypes=(torch.bfloat16,) * 4 + (torch.float32,),
          must_move=(), census=False, prepare=None):
    """Bs2 training steps at 800x1344 of the ``cfg`` detector, one per entry
    of ``dtypes`` (with the bench's random mask crops for a mask head).
    Returns the model, its parameters before the first step, the kernel
    launches of the run, kernel C's arguments in the first step by bin
    count (``{7: [...]}``, and ``14`` for the mask branch's; the first
    launch of each) and in the order of its launches (under ``'all'``),
    and whether every step gave finite losses (a "+fac" head's
    ``loss_multi_cls`` and a mask head's ``loss_mask`` among them) and
    launched kernel A once (never without a NonLocal refine in the neck)
    and B and C ``model.num_step_extractions`` times each (once, twice
    with a mask head, three times in a cascade, six in a cascade with mask
    heads, never in a single-stage detector; B once more with OHEM's hard
    mining, whose forward over every candidate builds no graph), the
    frozen parameters
    stayed without a gradient, every trainable tensor moved whose gradient
    was, in some step, large enough for the step to move it in f32 (the
    others are named: those with a gradient exactly 0 in every step, and
    those whose gradient the warm-up learning rate scales below rounding),
    and every tensor of the ``must_move`` modules moved (a name of the
    bbox head's, or a dotted prefix). The first step's B launches keep
    their arguments, in order, under ``'forward'``. With ``census`` the
    RoI sampler's choice in the first step is printed
    (:func:`_sampler_census`). ``prepare`` adjusts the seeded weights
    before the first step."""
    from arfe_tpu_torch.ops import fused_attention as fa
    from arfe_tpu_torch.ops import roi_align as ra
    from arfe_tpu_torch.train import make_train_step
    t0 = time.time()
    model, opt, scheduler, frozen = bench.build_trainer(cfg)
    if prepare is not None:
        prepare(model)
    step = make_train_step(model, opt, scheduler)
    with_mask = model.with_mask
    n_a, n_fwd, n_b = bench.step_launches(model)
    batches = {dt: bench.synthetic_batch(2, dtype=dt, masks=with_mask)
               for dt in set(dtypes)}
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
    # the dense head's weighted anchors at the coarsest level (last in the
    # anchor table), the only ones whose loss reaches that level
    rpn = model.dense_head
    top_stride = rpn.anchor_generator.strides[-1]
    n_top = rpn.num_anchors * -(-H // top_stride[1]) * -(-W // top_stride[0])
    targets, sampled = rpn._targets, {}

    def keep_weights(*args, **kwargs):
        out = targets(*args, **kwargs)
        sampled['weights'] = out[1]
        return out
    rpn._targets = keep_weights
    # kernel C's cotangent, RoIs and levels in the first step, for timing,
    # and the RoIs of that step's B launches, in the forward's order
    kernel_b, kernel_c = ra.roi_align_cuda, ra.roi_align_backward_cuda
    step_args, fwd_rois = {'all': [], 'forward': []}, []

    def keep_rois(feats, rois, lvls, *args, **kwargs):
        if ra.launches < n_fwd:
            fwd_rois.append(rois.clone())
            step_args['forward'].append((feats, rois.clone(), lvls.clone()))
        return kernel_b(feats, rois, lvls, *args, **kwargs)

    def keep_args(g, rois, lvls, shapes, *args, **kwargs):
        if ra.bwd_launches < n_b:
            step_args['all'].append([g.clone(), rois.clone(), lvls.clone(),
                                     [tuple(s) for s in shapes]])
            step_args.setdefault(g.shape[1], step_args['all'][-1])
        return kernel_c(g, rois, lvls, shapes, *args, **kwargs)
    ra.roi_align_cuda, ra.roi_align_backward_cuda = keep_rois, keep_args
    gen = torch.Generator(device='cuda').manual_seed(4)
    ok = True
    chosen = []
    if census:
        sample = model.roi_head.sampler.sample

        def keep_sample(g, assigned, **ctx):
            out = sample(g, assigned, **ctx)
            if not chosen:
                chosen.append((assigned.clone(), ctx['max_overlaps'].clone(),
                               {k: v.clone() for k, v in out.items()}))
            return out
        model.roi_head.sampler.sample = keep_sample
    fa.launches = ra.launches = ra.bwd_launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        for i, dt in enumerate(dtypes):
            counts = (fa.launches, ra.launches, ra.bwd_launches)
            lr = opt.param_groups[0]['lr']
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logs = step(batches[dt], gen)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            logs = {k: bench.log_value(v) for k, v in logs.items()}
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
            # FSAF's loss assigns its own targets
            top = (sampled['weights'][:, -n_top:] > 0).sum(-1).tolist() \
                if 'weights' in sampled else 'not sampled'
            good = all(np.isfinite(v).all() for v in logs.values()) \
                and grew == [n_a, n_fwd, n_b] \
                and ('loss_multi_cls' in logs
                     or not model.with_multi_cls) \
                and any(k.endswith('loss_mask') for k in logs) == with_mask
            ok = ok and good
            rois = ' and '.join(f'{a[1].shape[0]} RoIs at {a[0].shape[1]} x '
                                f'{a[0].shape[1]}' for a in step_args['all'])
            print(f'train step {i}: bs2 {str(dt)[6:]} {ms:.2f} ms, '
                  + ', '.join(f'{k} {v:.5f}' if isinstance(v, float)
                              else f'{k} {v}' for k, v in logs.items())
                  + f', launches attention {grew[0]} roi_align {grew[1]} '
                  f'roi_align_bwd {grew[2]} (over {rois or "no RoIs"}), '
                  f'anchors weighted at stride {top_stride[0]} '
                  f'{top} {"ok" if good else "FAIL"}')
    finally:
        del rpn._targets
        if census:
            del model.roi_head.sampler.sample
        ra.roi_align_cuda, ra.roi_align_backward_cuda = kernel_b, kernel_c
    if census:
        ok = _sampler_census(*chosen[0]) and ok
    # the backward runs in autograd's order, not the forward's: each C
    # launch's forward B launch (a cascade's stage), found by its RoIs
    step_args['forward_index'] = [
        [j for j, r in enumerate(fwd_rois) if torch.equal(r, a[1])]
        for a in step_args['all']]
    print(f"kernel C's launches of the first step against its B launches "
          f"(forward order): {step_args['forward_index']}")
    del fwd_rois
    launches = {'fused_attention': fa.launches, 'roi_align': ra.launches,
                'roi_align_bwd': ra.bwd_launches}
    print(f'train peak device memory over the steps '
          f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB')
    frozen_moved = [k for k in before if k not in had_grad and (
        not torch.equal(params[k], before[k]) or params[k].grad is not None)]
    no_grad = [k for k in trainable if params[k].grad is None
               or not bool(torch.isfinite(params[k].grad).all())]
    unchanged = [k for k in trainable if torch.equal(params[k], before[k])]
    zero_grad = [k for k in trainable if not had_grad[k]]
    small_grad = [k for k in unchanged if had_grad[k] and not movable[k]]
    stuck = [k for k in unchanged if movable[k]]
    mine = [k for k in params if any(
        k.startswith(m if '.' in m else f'roi_head.bbox_head.{m}.')
        for m in must_move)]
    mine_stuck = [k for k in mine if k in unchanged]
    refine = bench.refine_block(model)
    theta = None if refine is None else refine.theta.conv.weight.grad
    live = refine is None or (theta is not None
                              and float(theta.abs().max()) > 0)
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
    ar_fpn = isinstance(model.neck, torch.nn.Sequential) \
        and hasattr(model.neck[-1], 'reduce_convs')
    for dt, batch in batches.items() if ar_fpn else ():
        print(f'AR-FPN attention-map convs per level in {str(dt)[6:]}, '
              'outputs positive before the ReLU and of those unsaturated by '
              'tanh (reduce_convs: positive, unsaturated; reduce_convs2: the '
              f'same; of): {reduce_conv_activity(model, batch["img"])}')
    return model, before, launches, step_args, ok and good


def _sampler_census(assigned, overlaps, out):
    """How the RoI sampler spread its choice in a step, image by image: the
    positives per gt against each gt's candidates, and the negatives per
    IoU bin (thirds of [0, 0.5), the IoU-balanced sampler's) against each
    bin's. Balanced sampling (Libra) takes round robin: a gt or a bin short
    of the most taken by more than one has given all it has. Returns
    whether that holds."""
    ok = True
    for i in range(assigned.shape[0]):
        a, inds = assigned[i], out['inds'][i]
        pos, valid = out['is_pos'][i], out['valid'][i]
        g = int(a.max()) + 1
        bins = torch.clamp((overlaps[i] / 0.5 * 3).int(), 0, 2).long()
        pairs = [(torch.bincount(a[a > 0], minlength=g)[1:],
                  torch.bincount(a[inds[pos & valid]], minlength=g)[1:]),
                 (torch.bincount(bins[a == 0], minlength=3),
                  torch.bincount(bins[inds[valid & ~pos]], minlength=3))]
        good = True
        for have, took in pairs:
            top = int(took.max()) if took.numel() else 0
            good = good and all(t == h or t >= top - 1 for t, h in zip(
                took.tolist(), have.tolist()))
        ok = ok and good
        pos, neg = ([(t, h) for h, t in zip(have.tolist(), took.tolist())]
                    for have, took in pairs)
        print(f'sampler census, image {i}: positives per gt (taken of '
              f'candidates) {pos}; negatives per IoU third of [0, 0.5) '
              f'{neg} {"ok" if good else "FAIL"}')
    return ok


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
    with the same sampling priorities on both and the CPU's choice of
    proposals, and once more on the CPU with one thread
    (``bench.compare_with_cpu``). The starting weights give the
    check the same input in every run: after the five steps above, whose
    bf16 sums and atomic adds differ from run to run, some parameters'
    gradients can differ by more than the limit between two summation
    orders on the CPU alone. Each loss within ``bench.LOSS_RTOL`` + 4x
    the CPU's own spread, relative; each parameter's largest gradient
    difference within ``bench.GRAD_RTOL`` of its largest |g|, with the CPU's
    spread printed beside it; and the card's own choice of proposals the
    plain path's selection from the card's candidates, to the proposal. The
    kernels' own checks above hold them to f32 rounding. With ``readings``,
    also what the check reads for a 3% error
    of kernel C on one level. A ``cfg`` that is a ``Config`` (not the
    model's path: fewer RoIs, :func:`fewer_rois`) builds the card's model
    for the check too."""
    from arfe_tpu_torch.apis import init_detector
    h, w = 320, 480
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(start[k])
    if not isinstance(cfg, str):
        card = init_detector(cfg, train=True)
        card.load_state_dict(model.state_dict())
        model = card
    cpu = init_detector(cfg, device='cpu', train=True)
    cpu.load_state_dict(model.state_dict())
    batch = bench.synthetic_batch(2, h, w, (float(h), float(w)),
                                  torch.float32, seed=6, device='cpu',
                                  masks=model.with_mask)
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
          f'{bench.GRAD_RTOL:g}) over {r["params"]} parameters'
          + ('' if 'selection_faults' not in r else
             '; all on the CPU\'s proposals, of which the card\'s own RPN '
             f'chose others for {r["other_proposals"][1]}, the CPU\'s on 1 '
             f'thread for {r["other_proposals"][0]}; the card\'s own choice '
             'against the plain selection from its candidates: '
             f'{r["selection_faults"]} proposals differ (none may)')
          + f' {"ok" if r["ok"] else "FAIL"}')
    if 'hard' in r:
        hard = r['hard']
        print(f'train reference, OHEM hard scores (largest {hard["max"]:.4f})'
              f': the card {hard["err"]:.3e} off the CPU\'s, the CPU on 1 '
              f'thread {hard["spread"]:.3e} (tol {bench.HARD_RTOL:g} x '
              f'largest + 4x) over the candidates with the CPU\'s boxes '
              f'(other boxes: card {hard["moved"]}, CPU 1 thread '
              f'{hard["spread_moved"]}); the RoIs their own scores would '
              f'have sampled other than the CPU\'s: card {hard["flips"]}, '
              f'CPU 1 thread {hard["spread_flips"]} of 2 x 512; all three '
              f'runs ranked by the CPU\'s scores')
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
CLS_SCALE = {'arrff': 0.1, 'fac': 0.006, 'mask': 1.0, 'cascade': 2.0,
             'retina': 7.0, 'libra': 1.2, 'libra101': 1.0,
             'libra_retina': 5.0, 'bfp': 1.0, 'caffe': 1.15,
             'libra_x101': 250.0, 'c4_mask': 0.33, 'c4': 0.33,
             'cascade_mask': 2.0, 'v1': 1.15, 'fsaf': 7.0, 'giou': 1.1,
             'fpnbu': 1.3, 'relation': 1.04, 'cbam': 0.35, 'att': 0.021}
# Mask R-CNN's classifier is the flagship's and does not saturate (at
# 320x480: 19 detections score >= 0.1, the 100th 0.067); its entry draws
# conv_out on the CPU, as the others do. Cascade R-CNN averages its three
# stages' logits, which spread less (at 2: 26 detections score >= 0.1, the
# 100th 0.068). RetinaNet's entry scales the classifier's weights, its bias
# (the prior 0.01) kept: at random weights every score sits at the prior,
# under the 0.05 threshold (at 7: 11 detections score >= 0.1, the 100th
# 0.075). Libra at 1.2: 48 score >= 0.1, the 100th 0.091; R101 (its
# residual branches damped, ``damp_residuals``) at 1: 38, 0.089; Libra
# RetinaNet at 5: 3, 0.086; Faster + BFP at 1: 32, 0.071 (all on the CPU at
# 320x480). The caffe Faster and v1 Mask R-CNN at 1.15 and the C4 detectors
# at 0.33: their scores crowd (at 1.1 and 0.33, 6 and 25 score >= 0.1, the
# 100th 0.090 and 0.096). ResNeXt-101 at the seeded weights does the
# opposite of R101: its grouped 3x3 convs, initialised by fan-out over all
# output channels, shrink every residual branch, its features fall to ~0.1
# and its logits to ~4e-3, all scores at 1/81; at 250, 73 score >= 0.1,
# the 100th 0.097. Cascade Mask R-CNN at 2: 12, 0.086.


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
                step_args[7], key='_arrff_r3072', plain=True)
            _roi_census(step_args[7][1], step_args[7][2],
                        'AR-RFF training step')
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
# (h, w) of COCO val images: padded at (1333, 800) to 800x1088, 1088x800
# and 800x1216
EVAL_SIZES = [(480, 640), (640, 480), (427, 640), (375, 500)]
# the CPU's plain path runs the full-width detector at this scale, on the
# first COMPARE_IMAGES images of a set written for the CLIs (one of each
# aspect)
CPU_SCALE = (667, 400)
COMPARE_IMAGES = 2
STATS = ('bbox_mAP', 'bbox_AP50', 'bbox_AP75', 'bbox_APs', 'bbox_APm',
         'bbox_APl')


def _eval_config(scale=(1333, 800), workers=None, root=EVAL_ROOT,
                 path=PORT_CFG):
    """The AR-RFF config at ``path`` on the synthetic set under ``root`` at
    ``scale``."""
    from arfe_tpu_torch.config import Config
    cfg = Config.fromfile(path)
    cfg.data.test.update(ann_file=f'{root}/ann.json',
                         img_prefix=f'{root}/imgs')
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
    """(score, label, box) of each detection of an image's result (the
    boxes of a mask model's ``(bbox, segm)``)."""
    if isinstance(per_class, tuple):
        per_class = per_class[0]
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
    # first runs: one-time set-up per shape, without the loader's workers
    loader0 = build_test_loader(_eval_config(workers=0))[1]
    with RequestLog(model) as log:
        for dt in (bf, f32):
            runs[dt, 'warm'] = _timed_run(model, loader0, dt, log)[0]
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


def eval_reference_check(model, images, root=EVAL_ROOT, path=PORT_CFG,
                         match=False, metrics=('bbox',), categories=None):
    """The same weights and files (``root``) on the CPU's plain path and on
    the card in f32, at ``CPU_SCALE``; ground truth seeded from the CPU's
    detections (and masks). The six stats of each of ``metrics`` within
    1e-3, and the CPU's mAP inside (0.05, 0.999); detections the rule does
    not match are printed. With ``match``, every detection of each side
    must instead be matched on the other (weights whose detections are
    under the 2 px that ground truth is seeded from leave the stats at
    0)."""
    from arfe_tpu_torch.apis import init_detector, single_device_test
    from arfe_tpu_torch.data import synthetic
    from arfe_tpu_torch.tools.test import build_test_loader
    cfg = _eval_config(CPU_SCALE, root=root, path=path)
    cpu = init_detector(cfg, device='cpu')
    cpu.load_state_dict(model.state_dict())
    t0 = time.time()
    want = single_device_test(cpu, build_test_loader(cfg)[1],
                              show_progress=False)
    cpu_s = time.time() - t0
    got = single_device_test(model, build_test_loader(cfg)[1],
                             show_progress=False, dtype=torch.float32)
    synthetic.write_annotations(f'{root}/ann.json', images,
                                synthetic.seed_ground_truth(images, want),
                                categories or synthetic.CATEGORIES)
    dataset = build_test_loader(cfg)[0]
    s_cpu = dataset.evaluate(want, metric=list(metrics))
    s_card = dataset.evaluate(got, metric=list(metrics))
    stats = [k.replace('bbox', m) for m in metrics for k in STATS]
    diff = max(abs(s_cpu[k] - s_card[k]) for k in stats)
    unmatched, detections = 0, 0
    for i, (w, g) in enumerate(zip(want, got)):
        missing = _unmatched(_flat(w), _flat(g))
        extra = _unmatched(_flat(g), _flat(w))
        unmatched += len(missing) + len(extra)
        detections += len(_flat(w)) + len(_flat(g))
        if missing or extra:
            print(f'  image {i}: CPU detections unmatched on the card '
                  f'{missing[:5]}, card detections unmatched on the CPU '
                  f'{extra[:5]} ({len(_flat(w))} and {len(_flat(g))} '
                  'detections)')
    ok = diff <= 1e-3 and (unmatched == 0 and detections > 0 if match
                           else 0.05 < s_cpu['bbox_mAP'] < 0.999)
    print(f'eval card f32 against the CPU plain path at {CPU_SCALE} '
          f'({cpu_s:.1f} s on the CPU): CPU '
          + ', '.join(f'{k} {s_cpu[k]:.4f}' for k in stats) + '; card '
          + ', '.join(f'{k} {s_card[k]:.4f}' for k in stats)
          + f'; largest difference {diff:.2e} (tol 1e-3); {unmatched} of '
          f'{detections} detections unmatched'
          + (' (tol 0)' if match else '') + f' {"ok" if ok else "FAIL"}')
    return ok


# --------------------------------------------------------------------------
# phase 13: AR-RFF trained through the train CLI on a synthetic COCO set: 2
# epochs in bf16, epoch 2 again resumed from a copy of epoch_1.pth, then the
# test CLI on latest.pth
# --------------------------------------------------------------------------

TRAIN_ROOT = 'build/train_coco'
# COCO's two shapes, four of each: two aspect groups, 4 iterations of bs2
# an epoch, padded at (1333, 800) to 800x1088 and 1088x800
TRAIN_SIZES = [(480, 640), (640, 480)] * 4
# the uninterrupted run's iterations, the resumed run's, and the validated
# images of the uninterrupted run (evaluation.interval=2)
TRAIN_ITERS, RESUMED_ITERS, VAL_IMAGES = 8, 4, 8


class TrainRunLog:
    """Wraps ``train_detector``'s ``make_train_step``, ``save_checkpoint``
    and ``load_checkpoint``. Per iteration it keeps the kernels' launches,
    the batch's images and flips, the LR, the step's log values (on the
    device), when the step was called and when the card finished it (the
    wrapper synchronises, where the loop's per-iteration log synchronises
    anyway); with ``track_grads`` each trainable parameter's largest
    |gradient|; over the iterations ``profile`` (a pair of indices), the
    device's busy time under ``torch.profiler``. It also times each save
    and load of a checkpoint."""

    def __init__(self, track_grads=False, profile=None):
        from arfe_tpu_torch.apis import train as api
        self.api, self.track_grads, self.profile = api, track_grads, profile
        self.originals = (api.make_train_step, api.save_checkpoint,
                          api.load_checkpoint)
        self.iters, self.saves, self.loads = [], [], []
        self.names, self.prof, self.window = None, None, None

    def __enter__(self):
        make, save, load = self.originals
        self.api.make_train_step = self._make
        self.api.save_checkpoint = self._timed(save, self.saves)
        self.api.load_checkpoint = self._timed(load, self.loads)
        return self

    def __exit__(self, *exc):
        (self.api.make_train_step, self.api.save_checkpoint,
         self.api.load_checkpoint) = self.originals

    @staticmethod
    def _timed(fn, out):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            out.append(time.perf_counter() - t0)
            return result
        return timed

    def _make(self, model, optimizer, scheduler, grad_clip):
        from arfe_tpu_torch.ops import fused_attention as fa
        from arfe_tpu_torch.ops import roi_align as ra
        step = self.originals[0](model, optimizer, scheduler, grad_clip)
        by_id = {id(p): k for k, p in model.named_parameters()}
        params = [p for g in optimizer.param_groups for p in g['params']]
        self.names = [by_id[id(p)] for p in params]

        def logged(batch, gen):
            i = len(self.iters)
            if self.profile and i == self.profile[0]:
                self.prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                self.prof.start()
                self.window = [time.perf_counter()]
            start = time.perf_counter()
            counts = (fa.launches, ra.launches, ra.bwd_launches)
            lr = optimizer.param_groups[0]['lr']
            out = step(batch, gen)
            launches = tuple(n - c for n, c in zip(
                (fa.launches, ra.launches, ra.bwd_launches), counts))
            rec = dict(images=[m['ori_filename'] for m in batch['img_metas']],
                       flips=[bool(m['flip']) for m in batch['img_metas']],
                       lr=lr, launches=launches, logs=out, start=start)
            if self.track_grads:
                grads = [p.grad if p.grad is not None
                         else torch.zeros((), device=p.device) for p in params]
                rec['g_max'] = torch.stack(torch._foreach_norm(
                    grads, float('inf'))).tolist()
            torch.cuda.synchronize()
            rec['end'] = time.perf_counter()
            if self.profile and i == self.profile[1]:
                self.window.append(time.perf_counter())
                self.prof.stop()
            self.iters.append(rec)
            return out

        return logged

    def idle_share(self):
        """The profiled window's wall ms per iteration, device busy ms per
        iteration and idle share."""
        from arfe_tpu_torch.tools.profile_serve import _busy_us
        kernels = [e for e in self.prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        n = self.profile[1] - self.profile[0] + 1
        wall_us = (self.window[1] - self.window[0]) * 1e6
        busy = _busy_us(kernels)
        return wall_us / n / 1e3, busy / n / 1e3, 1 - busy / wall_us


def _train_cli_args(work, extra=()):
    data = [f'data.{split}.{k}={TRAIN_ROOT}/{v}' for split in
            ('train', 'val', 'test')
            for k, v in (('ann_file', 'ann.json'), ('img_prefix', 'imgs/'))]
    return [PORT_CFG, '--work-dir', work, '--seed', '0', '--dtype', 'bf16',
            '--options', *data, 'model.pretrained=None', 'total_epochs=2',
            'log_config.interval=1', 'evaluation.interval=2', *extra]


def _train_run_timing(log):
    """Seconds per iteration (from one step's call to the next's, within an
    epoch, the first iteration of the run left out) and, of each, the
    wait before the step: the loader, the batch's copy to the card and the
    log line."""
    per_epoch = TRAIN_ITERS // 2
    pairs = [(log.iters[i], log.iters[i + 1]) for i in range(TRAIN_ITERS - 1)
             if (i + 1) % per_epoch and i > 0]
    its = sorted(b['start'] - a['start'] for a, b in pairs)
    waits = sorted(b['start'] - a['end'] for a, b in pairs)
    shares = sorted((b['start'] - a['end']) / (b['start'] - a['start'])
                    for a, b in pairs)
    return its, waits, shares


def _moved_check(log, first, second, frozen_prefixes):
    """(d): between the two checkpoints' weights the frozen stem and layer1
    are equal, and every other trainable tensor moved whose gradient was, in
    some iteration between them, large enough for the step to move it in
    f32 (phase 5's rule: the largest |lr g| above 2^-20 of the largest
    |p|); those with a gradient exactly 0 in every iteration, or too small
    for the warm-up learning rate, are named."""
    frozen = [k for k in first if any(k.startswith(f)
                                      for f in frozen_prefixes)]
    frozen_moved = [k for k in frozen if not torch.equal(first[k],
                                                         second[k])]
    had_grad, movable = set(), set()
    for rec in log.iters:
        for k, g in zip(log.names, rec['g_max']):
            if g > 0:
                had_grad.add(k)
            if rec['lr'] * g > 2.0 ** -20 * float(first[k].abs().max()):
                movable.add(k)
    unchanged = [k for k in log.names if torch.equal(first[k], second[k])]
    stuck = [k for k in unchanged if k in movable]
    small = [k for k in unchanged if k in had_grad and k not in movable]
    zero = [k for k in log.names if k not in had_grad]
    moved = len(log.names) - len(unchanged)
    good = not frozen_moved and not stuck and len(frozen) > 10 and moved > 150
    print(f'train run (d) epoch_1.pth -> epoch_2.pth: frozen tensors '
          f'{len(frozen)}, moved {frozen_moved}; {moved}'
          f' of {len(log.names)} trainable moved; unchanged with a gradient '
          f'large enough to move them {stuck}; unchanged, the gradient too '
          f'small for the learning rate {small}; gradient exactly 0 in every '
          f'iteration {zero} {"ok" if good else "FAIL"}')
    return good


# classifier scales tried for the train run's card-against-CPU check, in
# turn: at random weights and after a few iterations from them, the class
# logits reach tens to hundreds, and where the softmax rounds to 1 the
# detection cut falls among ties (phase 12's CLS_SCALE)
SPREAD_SCALES = (1.0, 0.3, 0.1, 0.03, 0.01, 0.003, 0.001)


def _spread_classifier(model, cfg, scales=SPREAD_SCALES, bias=True):
    """Scales the card model's classifiers (``model.classifiers()``:
    weight and, with ``bias``, bias, so every logit) by the first of ``scales`` at which
    each image of ``cfg``'s test set gets at least 10 detections and no
    score reaches 0.999, on the card in f32. Returns whether one did."""
    from arfe_tpu_torch.apis import single_device_test
    from arfe_tpu_torch.tools.test import build_test_loader
    layers = model.classifiers()
    loader = build_test_loader(cfg)[1]
    applied, readings = 1.0, []
    for scale in scales:
        with torch.no_grad():
            for fc in layers:
                fc.weight.mul_(scale / applied)
                if bias:
                    fc.bias.mul_(scale / applied)
        applied = scale
        results = single_device_test(model, loader, show_progress=False)
        counts = [len(_flat(r)) for r in results]
        top = max((d[0] for r in results for d in _flat(r)), default=0.0)
        readings.append((scale, counts, round(top, 4)))
        if min(counts) >= 10 and top < 0.999:
            print(f'train run (f) classifier scaled by {scale:g} (scale, '
                  f'detections per image, top score: {readings})')
            return True
    print(f'train run (f) no classifier scale spreads the scores: '
          f'{readings} FAIL')
    return False


def train_run_arrff(name_limit):
    """Writes the box set, trains AR-RFF at full width through
    ``tools.train.main`` (bs2, bf16, 2 epochs, validation at epoch 2),
    resumes a copy of ``epoch_1.pth`` for epoch 2, and runs
    ``tools.test.main`` on ``latest.pth``. Checks (a)-(g) of the phase:
    (a) A, B and C launch once per iteration (and A, B once per validated
    image); (b) every logged loss is finite, ``train.log.json`` parses; (c)
    ``epoch_1.pth``, ``epoch_2.pth`` and ``latest.pth`` hold the optimizer
    and the scheduler; (d) ``_moved_check``; (e) the resumed epoch 2 has the
    uninterrupted run's images and flips batch by batch and its LRs, and
    its first iteration's losses; (f) the test CLI gives the six bbox
    stats, and the card's f32 detections with ``latest.pth`` match the
    CPU's plain path's one for one (phase 12's rule and classifier
    scaling; ``eval_reference_check(match=True)``); (g) the
    validation wrote a ``mode='val'`` line. Returns whether all held and
    the launches of the two training runs."""
    import shutil

    from arfe_tpu_torch.apis import init_detector
    from arfe_tpu_torch.data import synthetic
    from arfe_tpu_torch.ops import fused_attention as fa
    from arfe_tpu_torch.ops import roi_align as ra
    from arfe_tpu_torch.tools import test as test_cli
    from arfe_tpu_torch.tools import train as train_cli
    from arfe_tpu_torch.train import frozen_prefixes_from_cfg
    from arfe_tpu_torch.utils.checkpoint import load_checkpoint
    shutil.rmtree(TRAIN_ROOT, ignore_errors=True)
    t0 = time.time()
    images, anns = synthetic.write_box_set(TRAIN_ROOT, TRAIN_SIZES, seed=11)
    print(f'train set: {len(images)} PNGs at {TRAIN_SIZES[:2]}, '
          f'{len(anns)} boxes, written in {time.time() - t0:.1f} s')
    work, resumed = f'{TRAIN_ROOT}/work', f'{TRAIN_ROOT}/work_resumed'
    ok = True
    fa.launches = ra.launches = ra.bwd_launches = 0
    with TrainRunLog() as run:
        history = train_cli.main(_train_cli_args(work))
    os.makedirs(resumed)
    shutil.copy(f'{work}/epoch_1.pth', f'{resumed}/epoch_1.pth')
    with TrainRunLog(track_grads=True, profile=(1, 2)) as rerun:
        history_resumed = train_cli.main(_train_cli_args(
            resumed, ['--resume-from', f'{resumed}/epoch_1.pth',
                      '--no-validate']))
    launches = {'fused_attention': fa.launches, 'roi_align': ra.launches,
                'roi_align_bwd': ra.bwd_launches}
    # (a)
    per_iter = [r['launches'] for r in run.iters + rerun.iters]
    want = {'fused_attention': TRAIN_ITERS + RESUMED_ITERS + VAL_IMAGES,
            'roi_align': TRAIN_ITERS + RESUMED_ITERS + VAL_IMAGES,
            'roi_align_bwd': TRAIN_ITERS + RESUMED_ITERS}
    good = len(run.iters) == TRAIN_ITERS \
        and len(rerun.iters) == RESUMED_ITERS \
        and set(per_iter) == {(1, 1, 1)} and launches == want
    print(f'train run (a) launches per iteration (attention, roi_align, '
          f'roi_align_bwd) {sorted(set(per_iter))} over {len(per_iter)} '
          f'iterations; the two runs {launches} with the {VAL_IMAGES} '
          f'validated images (expected {want}) {"ok" if good else "FAIL"}')
    ok = ok and good
    # (b) and (g)
    with open(f'{work}/train.log.json') as f:
        lines = [json.loads(line) for line in f]
    losses = [v for e in history + history_resumed if e['mode'] == 'train'
              for k, v in e.items() if 'loss' in k]
    val = [e for e in lines if e['mode'] == 'val']
    good = all(np.isfinite(losses)) and len(losses) > 0 \
        and [e for e in lines if e['mode'] == 'train'] == [
            e for e in history if e['mode'] == 'train'] \
        and len(lines) == TRAIN_ITERS + 1
    print(f'train run (b) {len(losses)} logged losses finite, last loss '
          f'{[e for e in history if e["mode"] == "train"][-1]["loss"]:.4f}; '
          f'train.log.json parses, {len(lines)} lines '
          f'{"ok" if good else "FAIL"}')
    ok = ok and good
    good = len(val) == 1 and val[0]['epoch'] == 2 and all(
        k in val[0] for k in STATS)
    print(f'train run (g) validation line {val} {"ok" if good else "FAIL"}')
    ok = ok and good
    # (c)
    ckpts = {}
    for path in (f'{work}/epoch_1.pth', f'{work}/epoch_2.pth',
                 f'{resumed}/epoch_2.pth'):
        state, meta, opt_state, sched_state = load_checkpoint(path)
        ckpts[path] = state
        good = opt_state is not None and sched_state is not None \
            and len(opt_state['state']) > 150 \
            and sched_state['last_epoch'] == meta['iter']
        print(f'train run (c) {path}: epoch {meta["epoch"]}, iteration '
              f'{meta["iter"]}, {len(state)} tensors, momentum of '
              f'{len(opt_state["state"])}, scheduler at '
              f'{sched_state["last_epoch"]} {"ok" if good else "FAIL"}')
        ok = ok and good
    good = os.readlink(f'{work}/latest.pth') == 'epoch_2.pth'
    print(f'train run (c) latest.pth -> {os.readlink(f"{work}/latest.pth")} '
          f'{"ok" if good else "FAIL"}')
    ok = ok and good
    size_mb = os.path.getsize(f'{work}/epoch_2.pth') / 2 ** 20
    # (d)
    from arfe_tpu_torch.config import Config
    frozen = frozen_prefixes_from_cfg(Config.fromfile(PORT_CFG).model)
    ok = _moved_check(rerun, ckpts[f'{work}/epoch_1.pth'],
                      ckpts[f'{resumed}/epoch_2.pth'], frozen) and ok
    # (e)
    epoch2 = run.iters[TRAIN_ITERS // 2:]
    same_batches = [(a['images'], a['flips']) for a in epoch2] == [
        (b['images'], b['flips']) for b in rerun.iters]
    same_lr = [a['lr'] for a in epoch2] == [b['lr'] for b in rerun.iters]
    first, again = epoch2[0]['logs'], rerun.iters[0]['logs']
    bit_equal = all(torch.equal(first[k], again[k]) for k in first)
    rel = max(abs(float(first[k]) - float(again[k]))
              / max(abs(float(first[k])), 1e-12) for k in first)
    good = same_batches and same_lr and rel <= 1e-5
    print(f'train run (e) resumed epoch 2 against the uninterrupted run: '
          f'images and flips batch by batch {same_batches} '
          f'({[b["images"] + b["flips"] for b in rerun.iters]}), LRs '
          f'{same_lr} ({[b["lr"] for b in rerun.iters]}); first iteration\'s '
          f'losses bit for bit {bit_equal}, largest relative difference '
          f'{rel:.3e} (tol 1e-5) {"ok" if good else "FAIL"}')
    ok = ok and good
    # (f)
    dumped = f'{work}/{os.path.basename(PORT_CFG)}'
    metrics = test_cli.main([dumped, f'{work}/latest.pth', '--eval', 'bbox'])
    good = all(k in metrics and np.isfinite(metrics[k]) for k in STATS)
    print(f'train run (f) test CLI on latest.pth: '
          + ', '.join(f'{k} {metrics.get(k, float("nan")):.4f}'
                      for k in STATS) + f' {"ok" if good else "FAIL"}')
    ok = ok and good
    # the CPU's plain path at CPU_SCALE on four of the images, against the
    # card in f32 without TF32 (as phase 2 leaves it). After a few
    # iterations from random weights the background takes nearly every RoI
    # and no score passes the 0.05 threshold: the comparison keeps every
    # score (the config's copy with score_thr=0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    synthetic.write_annotations(f'{TRAIN_ROOT}/ann.json',
                                images[:COMPARE_IMAGES])
    compare = f'{TRAIN_ROOT}/compare_cfg.py'
    with open(compare, 'w') as f:
        f.write(f"_base_ = ['{os.path.abspath(dumped)}']\n"
                'test_cfg = dict(rcnn=dict(score_thr=0.0))\n')
    model = init_detector(compare, f'{work}/latest.pth')
    good = _spread_classifier(model, _eval_config(
        CPU_SCALE, workers=0, root=TRAIN_ROOT, path=compare))
    ok = good and eval_reference_check(model, images[:COMPARE_IMAGES],
                                       root=TRAIN_ROOT,
                                       path=compare, match=True) and ok
    del model
    torch.cuda.empty_cache()
    # the numbers
    its, waits, shares = _train_run_timing(run)
    med = its[len(its) // 2]
    wall_ms, busy_ms, idle = rerun.idle_share()
    print(f'train run bs2 bf16 at (1333, 800), 2 loader workers '
          f'({name_limit}): {med:.4f} s per iteration, median of '
          f'{len(its)} ({its[0]:.4f}-{its[-1]:.4f}); of it waiting before '
          f'the step (the loader, the copy to the card, the log) median '
          f'{waits[len(waits) // 2]:.4f} s ({waits[0]:.4f}-{waits[-1]:.4f}),'
          f' a share of {shares[len(shares) // 2]:.3f} '
          f'({shares[0]:.3f}-{shares[-1]:.3f}); {2 / med:.2f} images '
          f'trained per second; under the profiler (resumed run, iterations'
          f' 2-3) {wall_ms:.2f} ms per iteration, device busy '
          f'{busy_ms:.2f} ms, idle share {idle:.3f}')
    print(f'train run checkpoints: save {[round(s, 3) for s in run.saves]} '
          f's, load (resume) {[round(s, 3) for s in rerun.loads]} s, '
          f'{size_mb:.1f} MiB each')
    row = {'train_run_s_per_iter': med, 'train_run_loader_share':
           shares[len(shares) // 2], 'train_run_idle_share': idle,
           'train_run_ckpt_save_s': max(run.saves),
           'train_run_ckpt_mib': size_mb}
    return ok, launches, row


# --------------------------------------------------------------------------
# phases 14-17: Mask R-CNN + AR-FPN (config #5a): served, kernel B at 14 x
# 14 bins, trained (kernel C at 14 x 14), and trained and evaluated through
# the CLIs with bbox and segm
# --------------------------------------------------------------------------

MASK_PORT_CFG = 'arfe_tpu_torch/configs/mask_rcnn_r50_arfpn_1x_coco.py'
MASK_ROOT = 'build/mask_coco'
# the train CLI's run: one epoch of 4 iterations of bs2 on 8 polygon PNGs
MASK_TRAIN_ITERS = 4


def check_roi_align_mask(args):
    """Kernel B against ``roi_align_pyramid_plain`` at 14 x 14 bins on the
    mask RoIs (every detection slot, the padding's [0, 0, 0, 0] included),
    levels and features of the first bs1 and bs2 Mask R-CNN requests (R =
    100, 200), in bf16 and f32 (the bs2 levels cast to f32; bs1's from the
    f32 request): equal bit for bit, each timed by graph replay beside its
    bound and the plain version's time."""
    from arfe_tpu_torch.ops import roi_align as ra
    strides, size = (4, 8, 16, 32), (14, 14)
    ok, row = True, {}
    for b in (1, 2):
        for dt in (torch.bfloat16, torch.float32):
            feats, rois, lvls = args.get((b, dt, 14)) \
                or args[b, torch.bfloat16, 14]
            feats = [f.to(dt) for f in feats]
            num = rois.shape[0]

            def kernel():
                return ra.roi_align_cuda(feats, rois, lvls, size, strides, 2,
                                         True)
            got = kernel()
            ref = ra.roi_align_pyramid_plain(feats, rois, lvls, size,
                                             strides, 2, True)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            same = torch.equal(got, ref)
            pad = int(((rois[:, 3] <= rois[:, 1])
                       | (rois[:, 4] <= rois[:, 2])).sum())
            del got, ref
            ok = ok and same
            ms = cuda_ms(kernel, graph=True)
            plain_ms = cuda_ms(lambda: ra.roi_align_pyramid_plain(
                feats, rois, lvls, size, strides, 2, True), iters=5)
            bound, touched = _roi_align_bound(feats, rois, lvls, strides,
                                              size)
            print(f'roi_align at 14 x 14 R={num} B={b} {str(dt)[6:]} '
                  f'(Mask R-CNN request, {pad} slots of zero area, per level '
                  f'{torch.bincount(lvls.long(), minlength=4).tolist()}): '
                  f'equal to the plain version bit for bit {same}, '
                  f'max_abs_err {err:.3e}; kernel {ms:.4f} ms, plain '
                  f'{plain_ms:.4f} ms, bound {bound:.4f} ms ({touched} '
                  f'distinct pixels) {"ok" if same else "FAIL"}')
            key = f'_mask_r{num}' + ('_f32' if dt == torch.float32 else '')
            row.update({'max_abs_err' + key: err, 'ms' + key: ms,
                        'plain_ms' + key: plain_ms, 'bound_ms' + key: bound})
    return ok, row


def mask_rcnn(requests, train_dtypes):
    """(a) Serve Mask R-CNN (A once and B twice per request), check it
    against the CPU, mask logits included; (b) kernel B at 14 x 14 on the
    requests' mask RoIs; (c) train it (A once, B and C twice per step,
    ``loss_mask`` finite, ``mask_head.*`` moves), kernel C at 14 x 14 on
    the first step's mask cotangent, and a training step against the CPU.
    Returns each check's result, the serving and training runs' launches,
    and the rows' additions for B and C."""
    cfg = bench.MASK_CFG
    results, rows = {}, [{}, {}]
    with phase('mask: serve'):
        model = build_detector(cfg, CLS_SCALE['mask'])
        launches_serve, results['serve'], args = serve(model, requests)
    with phase('mask: card against CPU'):
        results['reference'] = reference_check(model, cfg)
    del model
    torch.cuda.empty_cache()
    with phase('mask: kernel B at 14 x 14'):
        results['kernel_b'], rows[0] = check_roi_align_mask(args)
    del args
    with phase('mask: train'):
        model, start, launches_train, step_args, results['train'] = \
            train(cfg, train_dtypes, ('roi_head.mask_head.',))
    with phase('mask: kernel C at 14 x 14'):
        results['kernel_c'], rows[1] = check_roi_align_bwd_step(
            step_args[14], key=f'_mask_r{step_args[14][1].shape[0]}',
            plain=True)
    del step_args
    with phase('mask: training step, card against CPU'):
        results['train_reference'] = train_reference_check(
            model, start, cfg, readings=False)
    del model
    torch.cuda.empty_cache()
    return results, launches_serve, launches_train, rows


class PasteLog:
    """Times each call of the host paste of predicted masks (one call per
    image, ``apis.inference.detections_to_results``)."""

    def __init__(self):
        from arfe_tpu_torch.apis import inference
        self.mod, self.paste = inference, inference.paste_masks_np
        self.calls = []

    def __enter__(self):
        def timed(mask_pred, *args, **kwargs):
            t0 = time.perf_counter()
            out = self.paste(mask_pred, *args, **kwargs)
            self.calls.append((len(mask_pred), time.perf_counter() - t0))
            return out
        self.mod.paste_masks_np = timed
        return self

    def __exit__(self, *exc):
        self.mod.paste_masks_np = self.paste


def evaluate_mask(name_limit):
    """(d) Writes 8 PNGs of polygon instances, trains Mask R-CNN at full
    width through ``tools.train.main`` (one epoch of 4 iterations, bs2
    bf16, masks and crops through the train pipeline), runs
    ``tools.test.main`` on ``latest.pth`` with ``--eval bbox segm``, and
    checks: every iteration launches A once, B and C twice; every evaluated
    image launches A once and B twice; the twelve stats print; the card's
    f32 bbox and segm stats with ``latest.pth`` within 1e-3 of the CPU's
    plain path at ``CPU_SCALE``, ground truth seeded from the CPU's
    detections and masks, every detection matched one for one (phase 13's
    classifier spread, ``score_thr=0``). Prints the host paste's time per
    image. Returns whether all held and the evaluation's launches."""
    import shutil

    from arfe_tpu_torch.apis import init_detector
    from arfe_tpu_torch.data import synthetic
    from arfe_tpu_torch.models.detectors import MaskRCNN
    from arfe_tpu_torch.ops import fused_attention as fa
    from arfe_tpu_torch.ops import roi_align as ra
    from arfe_tpu_torch.tools import test as test_cli
    from arfe_tpu_torch.tools import train as train_cli
    shutil.rmtree(MASK_ROOT, ignore_errors=True)
    t0 = time.time()
    images, anns = synthetic.write_polygon_set(MASK_ROOT, TRAIN_SIZES,
                                               seed=13)
    print(f'mask set: {len(images)} PNGs at {TRAIN_SIZES[:2]}, {len(anns)} '
          f'polygon instances, written in {time.time() - t0:.1f} s')
    work = f'{MASK_ROOT}/work'
    data = [f'data.{split}.{k}={MASK_ROOT}/{v}' for split in
            ('train', 'val', 'test')
            for k, v in (('ann_file', 'ann.json'), ('img_prefix', 'imgs/'))]
    ok = True
    fa.launches = ra.launches = ra.bwd_launches = 0
    with TrainRunLog() as run:
        history = train_cli.main([
            MASK_PORT_CFG, '--work-dir', work, '--seed', '0', '--dtype',
            'bf16', '--no-validate', '--options', *data,
            'model.pretrained=None', 'total_epochs=1',
            'log_config.interval=1'])
    per_iter = [r['launches'] for r in run.iters]
    losses = [e['loss_mask'] for e in history if e['mode'] == 'train']
    good = len(run.iters) == MASK_TRAIN_ITERS \
        and set(per_iter) == {(1, 2, 2)} and len(losses) == len(run.iters) \
        and all(np.isfinite(losses)) and os.path.exists(f'{work}/latest.pth')
    its = sorted(b['start'] - a['start']
                 for a, b in zip(run.iters[1:], run.iters[2:]))
    print(f'mask train CLI: {len(run.iters)} iterations bs2 bf16 at (1333, '
          f'800), launches per iteration (attention, roi_align, '
          f'roi_align_bwd) {sorted(set(per_iter))}, loss_mask '
          f'{[round(v, 4) for v in losses]}, s per iteration after the '
          f'first two {[round(v, 4) for v in its]} '
          f'{"ok" if good else "FAIL"}')
    ok = ok and good
    # the test CLI, each request's launches counted
    dumped = f'{work}/{os.path.basename(MASK_PORT_CFG)}'
    per_request, original = [], MaskRCNN.simple_test

    def counted(self, *args, **kwargs):
        counts = (fa.launches, ra.launches)
        out = original(self, *args, **kwargs)
        per_request.append((fa.launches - counts[0], ra.launches - counts[1]))
        return out
    fa.launches = ra.launches = ra.bwd_launches = 0
    MaskRCNN.simple_test = counted
    try:
        with PasteLog() as pastes:
            metrics = test_cli.main([dumped, f'{work}/latest.pth', '--eval',
                                     'bbox', 'segm'])
    finally:
        del MaskRCNN.simple_test
    launches = {'fused_attention': fa.launches, 'roi_align': ra.launches,
                'roi_align_bwd': ra.bwd_launches}
    n = len(images)
    stats = [k.replace('bbox', m) for m in ('bbox', 'segm') for k in STATS]
    good = set(per_request) == {(1, 2)} and len(per_request) == n \
        and launches == {'fused_attention': n, 'roi_align': 2 * n,
                         'roi_align_bwd': 0} \
        and all(k in metrics and np.isfinite(metrics[k]) for k in stats)
    print(f'mask test CLI on latest.pth --eval bbox segm: launches per image '
          f'(attention, roi_align) {sorted(set(per_request))} over '
          f'{len(per_request)} images, {launches}; '
          + ', '.join(f'{k} {metrics.get(k, float("nan")):.4f}'
                      for k in stats) + f' {"ok" if good else "FAIL"}')
    ok = ok and good
    # the card in f32 against the CPU at CPU_SCALE on four images, every
    # score kept and the classifier spread (phase 13)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    synthetic.write_annotations(f'{MASK_ROOT}/ann.json',
                                images[:COMPARE_IMAGES])
    compare = f'{MASK_ROOT}/compare_cfg.py'
    with open(compare, 'w') as f:
        f.write(f"_base_ = ['{os.path.abspath(dumped)}']\n"
                'test_cfg = dict(rcnn=dict(score_thr=0.0))\n')
    model = init_detector(compare, f'{work}/latest.pth')
    cfg = _eval_config(CPU_SCALE, workers=0, root=MASK_ROOT, path=compare)
    with PasteLog() as pastes:
        good = _spread_classifier(model, cfg)
        ok = good and eval_reference_check(
            model, images[:COMPARE_IMAGES], root=MASK_ROOT, path=compare,
            match=True,
            metrics=('bbox', 'segm')) and ok
    full = sorted(t for k, t in pastes.calls if k == 100)
    if full:
        print(f'mask host paste (100 masks into a 480x640 or 640x480 '
              f'image, numpy): median {full[len(full) // 2] * 1e3:.2f} ms '
              f'per image ({full[0] * 1e3:.2f}-{full[-1] * 1e3:.2f}) over '
              f'{len(full)} images ({name_limit} host)')
    del model
    torch.cuda.empty_cache()
    row = {'mask_paste_ms_per_image': full[len(full) // 2] * 1e3
           if full else None}
    return ok, launches, row


# --------------------------------------------------------------------------
# phases 18-25: Cascade R-CNN + AR-FPN (config #5b) and RetinaNet + AR-FPN
# (config #2): served, kernel B on each cascade stage's RoIs and kernel A at
# RetinaNet's refine level, trained (kernel C on each stage's cotangent),
# and trained and evaluated through the CLIs
# --------------------------------------------------------------------------

CASCADE_PORT_CFG = 'arfe_tpu_torch/configs/cascade_rcnn_r50_arfpn_1x_coco.py'
RETINA_PORT_CFG = 'arfe_tpu_torch/configs/retinanet_r50_arfpn_1x_coco.py'
# RetinaNet's classifier weights (its bias, the prior, kept) scaled up in
# turn for the check of a trained checkpoint: at random weights every score
# sits at the prior 0.01, under the 0.05 threshold
RETINA_SPREAD_SCALES = tuple(2.0 ** i for i in range(14))


def _roi_align_bit_for_bit(feats, rois, lvls, dt, what, key, row,
                           out_size=(7, 7)):
    """Kernel B against ``roi_align_pyramid_plain`` on these arguments, the
    levels cast to ``dt``, at ``out_size`` bins: equal bit for bit; timed
    by graph replay beside its bound and the plain version's time, which go
    into ``row`` under ``key`` (``_f32`` appended in f32). Returns whether
    it was equal."""
    from arfe_tpu_torch.ops import roi_align as ra
    strides = _level_strides([f.shape for f in feats])
    feats = [f.to(dt) for f in feats]
    num = rois.shape[0]

    def kernel():
        return ra.roi_align_cuda(feats, rois, lvls, out_size, strides, 2,
                                 True)

    def plain():
        return ra.roi_align_pyramid_plain(feats, rois, lvls, out_size,
                                          strides, 2, True)
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    same = torch.equal(got, ref) and bool(torch.isfinite(got).all())
    del got, ref
    ms = cuda_ms(kernel, graph=True)
    plain_ms = cuda_ms(plain, iters=5)
    bound, touched = _roi_align_bound(feats, rois, lvls, strides, out_size)
    print(f'roi_align {what} R={num} at {out_size[0]} x {out_size[1]}, '
          f'{feats[0].shape[-1]} channels, {str(dt)[6:]} (per level '
          f'{torch.bincount(lvls.long(), minlength=len(feats)).tolist()}): '
          f'equal to the plain version bit for bit {same}, max_abs_err '
          f'{err:.3e}; '
          f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms '
          f'({touched} distinct pixels) {"ok" if same else "FAIL"}')
    key += '_f32' if dt == torch.float32 else ''
    row.update({'max_abs_err' + key: err, 'ms' + key: ms,
                'plain_ms' + key: plain_ms, 'bound_ms' + key: bound})
    return same


def check_roi_align_stages(args, stages=3, prefix='_cascade',
                           what='cascade'):
    """Kernel B (:func:`_roi_align_bit_for_bit`) on each RoI head stage's
    RoIs, levels and features in the first bs1 and bs2 requests (R = 1000,
    2000 a stage: stage 0 the RPN's proposals, a cascade's stages 1 and 2
    the boxes the previous stage regressed), bf16 and f32 (the bs2 levels
    cast to f32; bs1's from the f32 request). The row's keys are
    ``{prefix}_s{i}_r{R}`` (``{prefix}_r{R}`` for one stage)."""
    ok, row = True, {}
    for b in (1, 2):
        for dt in (torch.bfloat16, torch.float32):
            for i in range(stages):
                feats, rois, lvls = args.get((b, dt, 'stage', i)) \
                    or args[b, torch.bfloat16, 'stage', i]
                stage = f'_s{i}' if stages > 1 else ''
                ok = _roi_align_bit_for_bit(
                    feats, rois, lvls, dt,
                    f'{what}{f" stage {i}" if stages > 1 else ""} B={b}',
                    f'{prefix}{stage}_r{rois.shape[0]}', row) and ok
    return ok, row


def _empty_split_count(n, dtype):
    """The smallest key split count of ``dtype``'s kernel over ``n`` keys
    that leaves a split without keys."""
    from arfe_tpu_torch.ops import fused_attention as fa
    tiles = -(-n // fa.TILES[dtype][1])
    return next(s for s in range(2, fa.MOST_SPLITS + 1)
                if -(-tiles // -(-tiles // s)) < s)


def check_attention_level(args, prefix='_retina', what='RetinaNet'):
    """Kernel A on the NonLocal refine level of the first bs1 and bs2
    requests (RetinaNet's and Libra's: N = 25 x 42 = 1050 tokens at stride
    32 of 800x1344; BFP's: N = 50 x 84 = 4200 at stride 16), bf16 and f32
    (the bs2 inputs cast to f32): against the plain version (in f32 also
    the exact f64 result, phase 12's rule), with the split count
    ``key_splits`` picks and with a forced count that leaves splits without
    keys; timed by graph replay beside its bound, the plain version and
    SDPA. The row's keys are ``{prefix}_n{N}``, ``_b2`` and ``_f32``
    appended."""
    from arfe_tpu_torch.ops import fused_attention as fa
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ok, row = True, {}
    for b in (1, 2):
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (t.to(dt) for t in (args.get((b, dt, 'a'))
                                          or args[b, torch.bfloat16, 'a']))
            n, c = q.shape[1:]
            got, ref = fa.fused_attention_cuda(q, k, v), \
                fa.attention_plain(q, k, v)
            forced = _empty_split_count(n, dt)
            empty = fa._launch(q, k, v, None, forced)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            err_empty = (empty - ref).abs().max().item()
            good = bool(torch.isfinite(got).all()) \
                and bool(torch.isfinite(empty).all())
            if dt == torch.float32:
                exact = torch.softmax(
                    q.double() @ k.double().transpose(-1, -2), -1) \
                    @ v.double()
                err_exact = (got.double() - exact).abs().max().item()
                plain_exact = (ref.double() - exact).abs().max().item()
                del exact
                tol = 1e-4 + plain_exact
                good = good and err_exact <= 1e-4
                detail = (f'; against f64: kernel {err_exact:.3e} (tol '
                          f'1e-4), plain {plain_exact:.3e}')
            else:
                tol = 2.0 ** -8 * v.float().abs().max().item()
                detail = ''
            good = good and err <= tol and err_empty <= tol
            ok = ok and good
            splits = fa.key_splits(b, n, sms, dt)

            def kernel():
                return fa.fused_attention_cuda(q, k, v)
            q4, k4, v4 = (t[:, None] for t in (q, k, v))
            ms = cuda_ms(kernel, graph=True)
            plain_ms = cuda_ms(lambda: fa.attention_plain(q, k, v))
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, scale=1.0), graph=True)
            bound, by = _attention_bound(b, n, c, dt)
            print(f'attention {what} refine level B={b} N={n} '
                  f'{str(dt)[6:]}, max |v| {v.float().abs().max().item():.2f}'
                  f', splits {splits} ({-(-n // fa.TILES[dt][0]) * b * splits}'
                  f' blocks): max_abs_err {err:.3e} against plain (tol '
                  f'{tol:.3e}){detail}; forced {forced} splits (some without '
                  f'keys) {err_empty:.3e}; kernel {ms:.4f} ms, plain '
                  f'{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound '
                  f'{bound:.4f} ms ({by}) {"ok" if good else "FAIL"}')
            key = f'{prefix}_n{n}' + ('_b2' if b == 2 else '') + (
                '_f32' if dt == torch.float32 else '')
            row.update({'max_abs_err' + key: err, 'ms' + key: ms,
                        'plain_ms' + key: plain_ms,
                        'library_ms' + key: lib_ms, 'bound_ms' + key: bound,
                        'splits' + key: splits, 'n' + key: n})
    return ok, row


def cascade_rcnn(requests, train_dtypes):
    """(a) Serve Cascade R-CNN (A once, B three times per request) and check
    it against the CPU; (b) kernel B on each stage's RoIs of the requests;
    (c) train it (A once, B and C three times per step; the later stages'
    heads move), kernel C on each stage's cotangent and RoIs of the first
    step, and a training step against the CPU. Returns each check's result,
    the serving and training runs' launches, and the rows' additions for A,
    B and C."""
    cfg = bench.CASCADE_CFG
    results, rows = {}, [{}, {}, {}]
    with phase('cascade: serve'):
        model = build_detector(cfg, CLS_SCALE['cascade'])
        launches_serve, results['serve'], args = serve(model, requests)
    with phase('cascade: card against CPU'):
        results['reference'] = reference_check(model, cfg)
    del model
    torch.cuda.empty_cache()
    with phase("cascade: kernel B on each stage's RoIs"):
        results['kernel_b'], rows[1] = check_roi_align_stages(args)
    del args
    with phase('cascade: train'):
        model, start, launches_train, step_args, results['train'] = train(
            cfg, train_dtypes, tuple(f'roi_head.bbox_head.{i}.{m}'
                                     for i in (1, 2)
                                     for m in ('shared_fcs', 'fc_cls')))
    with phase("cascade: kernel C on each stage's cotangent"):
        # each C launch's stage is that of the one B launch with its RoIs
        stage_of = [j[0] if len(j) == 1 else None
                    for j in step_args['forward_index']]
        ok = sorted(stage_of, key=str) == [0, 1, 2]
        print(f'kernel C launches by stage {stage_of} '
              f'{"ok" if ok else "FAIL"}')
        for i, a in sorted(zip(stage_of, step_args['all']),
                           key=lambda sa: str(sa[0])):
            good, row = check_roi_align_bwd_step(
                a, key=f'_cascade_s{i}_r{a[1].shape[0]}', plain=i == 0)
            ok = ok and good
            rows[2].update(row)
        results['kernel_c'] = ok
    del step_args
    with phase('cascade: training step, card against CPU'):
        results['train_reference'] = train_reference_check(
            model, start, cfg, readings=False)
    del model
    torch.cuda.empty_cache()
    return results, launches_serve, launches_train, rows


def retinanet(requests, train_dtypes):
    """(a) Serve RetinaNet (A once, B never per request) and check it
    against the CPU; (b) kernel A at its refine level on the requests'
    inputs; (c) train it (A once, B and C never per step; the head's last
    convs and its classifier move) and check a training step against the
    CPU. Returns each check's result, the serving and training runs'
    launches, and the rows' additions for A."""
    cfg = bench.RETINA_CFG
    results, rows = {}, [{}, {}, {}]
    with phase('retina: serve'):
        model = build_detector(cfg, CLS_SCALE['retina'])
        launches_serve, results['serve'], args = serve(model, requests)
    with phase('retina: card against CPU'):
        results['reference'] = reference_check(model, cfg)
    del model
    torch.cuda.empty_cache()
    with phase('retina: kernel A at N = 1050'):
        results['kernel_a'], rows[0] = check_attention_level(args)
    del args
    with phase('retina: train'):
        model, start, launches_train, _, results['train'] = train(
            cfg, train_dtypes, ('bbox_head.retina_cls',
                                'bbox_head.retina_reg',
                                'bbox_head.cls_convs.3',
                                'bbox_head.reg_convs.3'))
    with phase('retina: training step, card against CPU'):
        results['train_reference'] = train_reference_check(
            model, start, cfg, readings=False)
    del model
    torch.cuda.empty_cache()
    return results, launches_serve, launches_train, rows


@contextlib.contextmanager
def _keep_first(kept, kind):
    """With ``kept`` a dict, keeps the arguments of the first launch of
    kernel B (``kind`` ``'b'``) or C (``'c'``) inside the block under
    ``kept[kind]``."""
    from arfe_tpu_torch.ops import roi_align as ra
    if kept is None:
        yield
        return
    name = 'roi_align_cuda' if kind == 'b' else 'roi_align_backward_cuda'
    kernel = getattr(ra, name)

    def keep(*args, **kwargs):
        if kind == 'b' and 'b' not in kept:
            feats, rois, lvls = args[:3]
            kept['b'] = (list(feats), rois.clone(), lvls.clone())
        elif kind == 'c' and 'c' not in kept:
            g, rois, lvls, shapes = args[:4]
            kept['c'] = [g.clone(), rois.clone(), lvls.clone(),
                         [tuple(x) for x in shapes]]
        return kernel(*args, **kwargs)
    setattr(ra, name, keep)
    try:
        yield
    finally:
        setattr(ra, name, kernel)


def train_and_evaluate(name, port_cfg, root, n_b, name_limit, n_a=1,
                       categories=None, splits=('train', 'val', 'test'),
                       kernels=None, before_train=None):
    """Writes 8 box PNGs under ``root``, trains the ``port_cfg`` detector at
    full width through ``tools.train.main`` (one epoch of 4 iterations, bs2
    bf16; images read in the calling process, ``data.workers_per_gpu=0``,
    which the test CLI takes from the run's copy of the config: phases
    12, 13 and 17 run the loaders' spawned workers), runs
    ``tools.test.main`` on ``latest.pth`` with ``--eval bbox``,
    and checks: every iteration launches A ``n_a`` times, B and C ``n_b``
    times; every evaluated image A ``n_a`` times and B ``n_b`` times; the six stats print;
    the card's f32 stats with ``latest.pth`` within 1e-3 of the CPU's plain
    path at ``CPU_SCALE``, ground truth seeded from the CPU's detections,
    every detection matched one for one. A two-stage detector keeps every
    score and its classifiers are spread down (phase 13); RetinaNet keeps
    its 0.05 threshold and its classifier's weights are spread up
    (``RETINA_SPREAD_SCALES``). ``categories`` (default COCO's) label the
    set's boxes; ``splits`` are the data sections pointed at the set by
    ``--options`` (a config whose ``data.train`` is a list names its sets
    itself). With ``kernels`` (a dict), the first training iteration's
    first kernel C arguments and the first evaluated image's first kernel
    B arguments are kept there under ``'c'`` and ``'b'``; ``before_train``
    is called with the set's images and annotations before training.
    Returns whether all held and the evaluation's launches."""
    import shutil

    from arfe_tpu_torch.apis import init_detector
    from arfe_tpu_torch.config import Config
    from arfe_tpu_torch.data import synthetic
    from arfe_tpu_torch.models import detectors
    from arfe_tpu_torch.ops import fused_attention as fa
    from arfe_tpu_torch.ops import roi_align as ra
    from arfe_tpu_torch.tools import test as test_cli
    from arfe_tpu_torch.tools import train as train_cli
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.time()
    categories = categories or synthetic.CATEGORIES
    images, anns = synthetic.write_box_set(root, TRAIN_SIZES, seed=17,
                                           categories=categories)
    print(f'{name} set: {len(images)} PNGs at {TRAIN_SIZES[:2]}, {len(anns)} '
          f'boxes, written in {time.time() - t0:.1f} s')
    if before_train is not None:
        before_train(images, anns)
    work = f'{root}/work'
    data = [f'data.{split}.{k}={root}/{v}' for split in splits
            for k, v in (('ann_file', 'ann.json'), ('img_prefix', 'imgs/'))]
    ok = True
    fa.launches = ra.launches = ra.bwd_launches = 0
    with TrainRunLog() as run, _keep_first(kernels, 'c'):
        history = train_cli.main([
            port_cfg, '--work-dir', work, '--seed', '0', '--dtype', 'bf16',
            '--no-validate', '--options', *data, 'model.pretrained=None',
            'total_epochs=1', 'log_config.interval=1',
            'data.workers_per_gpu=0'])
    per_iter = [r['launches'] for r in run.iters]
    losses = [v for e in history if e['mode'] == 'train'
              for k, v in e.items() if 'loss' in k]
    good = len(run.iters) == MASK_TRAIN_ITERS \
        and set(per_iter) == {(n_a, n_b, n_b)} and len(losses) > 0 \
        and all(np.isfinite(losses)) and os.path.exists(f'{work}/latest.pth')
    its = sorted(b['start'] - a['start']
                 for a, b in zip(run.iters[1:], run.iters[2:]))
    print(f'{name} train CLI: {len(run.iters)} iterations bs2 bf16 at (1333, '
          f'800), launches per iteration (attention, roi_align, '
          f'roi_align_bwd) {sorted(set(per_iter))}, last loss '
          f'{[e for e in history if e["mode"] == "train"][-1]["loss"]:.4f}, '
          f's per iteration after the first two '
          f'{[round(v, 4) for v in its]} {"ok" if good else "FAIL"}')
    ok = ok and good
    # the test CLI, each request's launches counted
    dumped = f'{work}/{os.path.basename(port_cfg)}'
    cls = getattr(detectors, Config.fromfile(port_cfg).model.type)
    per_request, original = [], cls.simple_test

    def counted(self, *args, **kwargs):
        counts = (fa.launches, ra.launches)
        out = original(self, *args, **kwargs)
        per_request.append((fa.launches - counts[0], ra.launches - counts[1]))
        return out
    fa.launches = ra.launches = ra.bwd_launches = 0
    cls.simple_test = counted
    try:
        with _keep_first(kernels, 'b'):
            metrics = test_cli.main([dumped, f'{work}/latest.pth', '--eval',
                                     'bbox'])
    finally:
        cls.simple_test = original
    launches = {'fused_attention': fa.launches, 'roi_align': ra.launches,
                'roi_align_bwd': ra.bwd_launches}
    n = len(images)
    good = set(per_request) == {(n_a, n_b)} and len(per_request) == n \
        and launches == {'fused_attention': n_a * n, 'roi_align': n_b * n,
                         'roi_align_bwd': 0} \
        and all(k in metrics and np.isfinite(metrics[k]) for k in STATS)
    print(f'{name} test CLI on latest.pth --eval bbox: launches per image '
          f'(attention, roi_align) {sorted(set(per_request))} over '
          f'{len(per_request)} images, {launches}; '
          + ', '.join(f'{k} {metrics.get(k, float("nan")):.4f}'
                      for k in STATS) + f' {"ok" if good else "FAIL"}')
    ok = ok and good
    # the card in f32 against the CPU at CPU_SCALE on four images
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    synthetic.write_annotations(f'{root}/ann.json', images[:COMPARE_IMAGES],
                                categories=categories)
    compare = f'{root}/compare_cfg.py'
    two_stage = n_b > 0
    with open(compare, 'w') as f:
        f.write(f"_base_ = ['{os.path.abspath(dumped)}']\n"
                + ('test_cfg = dict(rcnn=dict(score_thr=0.0))\n'
                   if two_stage else ''))
    model = init_detector(compare, f'{work}/latest.pth')
    cfg = _eval_config(CPU_SCALE, workers=0, root=root, path=compare)
    good = _spread_classifier(model, cfg) if two_stage else \
        _spread_classifier(model, cfg, RETINA_SPREAD_SCALES, bias=False)
    ok = good and eval_reference_check(model, images[:COMPARE_IMAGES],
                                       root=root,
                                       path=compare, match=True,
                                       categories=categories) and ok
    del model
    torch.cuda.empty_cache()
    return ok, launches


# --------------------------------------------------------------------------
# phases 26-36: Libra R-CNN + ARFE at R50 and R101, Libra RetinaNet with
# BFP, Faster R-CNN with OHEM and with BFP
# --------------------------------------------------------------------------

# R101's residual branches at the seeded random weights: stage 3's 23
# blocks grow the features to ~6e4 (R50's reach ~50), every served score
# rounds to one value and the detections' order is a tie. Each block's
# last BatchNorm scale is damped by this factor, which keeps them at R50's
# size (stage 4's output ~70 at 320x480 on the CPU).
R101_DAMP = 0.6


def damp_residuals(model, factor=R101_DAMP):
    """Scales each residual block's last BatchNorm weight (``bn3``) of the
    backbone by ``factor``."""
    with torch.no_grad():
        for name, p in model.backbone.named_parameters():
            if name.endswith('bn3.weight'):
                p.mul_(factor)
    return model


def check_balanced_sampler(model, num_gts=16):
    """The detector's RoI sampler (Libra's: instance-balanced positives,
    IoU-balanced negatives) on the card against the CPU, on one skewed
    assignment of two images' ``nms_post + num_gts`` candidates (a random
    step's proposals overlap no gt by more than 1/6, so its sampling takes
    the balanced ranking through no choice): 191 positives over 8 gts in
    counts 100 to 1 and negatives whose IoUs crowd the lowest bin, the
    draws fixed by ``bench.fix_priorities``. The slots must be equal and
    the CPU's choice round robin (:func:`_sampler_census`); the card's
    sampling is timed (events, not a graph)."""
    sampler = model.roi_head.sampler
    n = model.train_cfg['rpn_proposal']['nms_post'] + num_gts
    r = np.random.RandomState(8)
    assigned = np.zeros((2, n), np.int64)
    overlaps = 0.5 * r.uniform(size=(2, n)) ** 4
    pos = np.repeat(np.arange(1, 9), [100, 50, 20, 10, 5, 3, 2, 1])
    for i in range(2):
        slots = r.permutation(n)[:len(pos)]
        assigned[i, slots] = pos
        overlaps[i, slots] = r.uniform(0.5, 1.0, len(pos))
    assigned[:, r.permutation(n)[:40]] = -1
    bench.fix_priorities(model, num_gts, H, W)
    cpu = [torch.from_numpy(assigned), torch.from_numpy(
        overlaps.astype(np.float32))]
    card_args = [t.cuda() for t in cpu]

    def sample(a, o):
        return sampler.sample(None, a, max_overlaps=o, num_gts=num_gts)
    want, got = sample(*cpu), sample(*card_args)
    same = all(torch.equal(got[k].cpu(), want[k]) for k in want)
    ms = cuda_ms(lambda: sample(*card_args), iters=10)
    print(f'balanced sampler ({type(sampler.pos_sampler).__name__}, '
          f'{type(sampler.neg_sampler).__name__}) on 2 x {n} candidates: '
          f'the card\'s slots equal to the CPU\'s {same}; {ms:.4f} ms on '
          f'the card {"ok" if same else "FAIL"}')
    return _sampler_census(cpu[0], cpu[1], want) and same


def libra(requests, train_dtypes, name_limit):
    """Libra R-CNN + ARFE (R50, ``configs/libra_rcnn/libra_faster_rcnn_r50_
    fpn_1x_coco.py``): (a) served (A once, at AR-FPN's refine level 3, N =
    1050; B once) and against the CPU; (b) kernels A and B on the requests'
    arguments; (c) trained with the balanced samplers and balanced L1 (A,
    B and C once a step; the first step's sampling census), C on the first
    step's cotangent and RoIs, the balanced sampler on a skewed assignment
    against the CPU, a step against the CPU; (d) the train and
    test CLIs (``train_and_evaluate``). Returns each check's result, the
    serving, training and evaluation runs' launches, and the rows'
    additions for A, B and C."""
    cfg = bench.LIBRA_CFG
    results, rows = {}, [{}, {}, {}]
    with phase('libra: serve'):
        model = build_detector(cfg, CLS_SCALE['libra'])
        launches_serve, results['serve'], args = serve(model, requests)
    with phase('libra: card against CPU'):
        results['reference'] = reference_check(model, cfg)
    del model
    torch.cuda.empty_cache()
    with phase('libra: kernels A at N = 1050 and B on the requests'):
        results['kernel_a'], rows[0] = check_attention_level(
            args, '_libra', 'Libra + ARFE')
        results['kernel_b'], rows[1] = check_roi_align_stages(
            args, 1, '_libra', 'Libra + ARFE')
    del args
    with phase('libra: train'):
        model, start, launches_train, step_args, results['train'] = train(
            cfg, train_dtypes, ('fc_reg',), census=True)
    with phase('libra: kernel C on a step'):
        results['kernel_c'], rows[2] = check_roi_align_bwd_step(
            step_args[7], key='_libra_r1024', plain=True)
    del step_args
    with phase('libra: balanced sampler, card against CPU'):
        results['sampler'] = check_balanced_sampler(model)
    with phase('libra: training step, card against CPU'):
        results['train_reference'] = train_reference_check(
            model, start, cfg, readings=False)
    del model
    torch.cuda.empty_cache()
    with phase('libra: train and evaluate through the CLIs'):
        results['evaluate'], launches_eval = train_and_evaluate(
            'libra', cfg, 'build/libra_coco', 1, name_limit)
    return results, launches_serve, launches_train, rows, launches_eval


def libra101(train_dtypes):
    """Libra R-CNN + ARFE at R101 (``libra_faster_rcnn_r101_fpn_1x_coco.
    py``; its residual branches damped, :data:`R101_DAMP`): served bs1
    (A and B once) and against the CPU, then trained at bs2 (A, B and C
    once a step), its peak memory printed. Returns each check's result and
    the serving and training runs' launches."""
    cfg = bench.LIBRA101_CFG
    results = {}
    with phase('libra101: serve'):
        model = build_detector(cfg, CLS_SCALE['libra101'])
        damp_residuals(model)
        launches_serve, results['serve'], _ = serve(
            model, [(1, torch.bfloat16)] * 2)
        print(f'R101 stage 3 blocks: {len(model.backbone.layer3)}')
    with phase('libra101: card against CPU'):
        results['reference'] = reference_check(model, cfg)
    del model
    torch.cuda.empty_cache()
    with phase('libra101: train'):
        model, _, launches_train, _, results['train'] = train(
            cfg, train_dtypes, prepare=damp_residuals)
    del model
    torch.cuda.empty_cache()
    return results, launches_serve, launches_train


def libra_retina(requests, train_dtypes):
    """Libra RetinaNet (``libra_retinanet_r50_fpn_1x_coco.py``: BFP at
    refine level 1 of P3-P7, balanced L1 at beta 0.11): (a) served (A once,
    at stride 16: N = 50 x 84 = 4200; no B) and against the CPU; (b) kernel
    A on BFP's gathered feature of the requests; (c) trained (A once, no B
    or C) and a step against the CPU. Returns each check's result, the
    serving and training runs' launches, and the row's additions for A."""
    cfg = bench.LIBRA_RETINA_CFG
    results, rows = {}, [{}, {}, {}]
    with phase('libra_retina: serve'):
        model = build_detector(cfg, CLS_SCALE['libra_retina'])
        launches_serve, results['serve'], args = serve(model, requests)
    with phase('libra_retina: card against CPU'):
        results['reference'] = reference_check(model, cfg)
    del model
    torch.cuda.empty_cache()
    with phase('libra_retina: kernel A at N = 4200'):
        results['kernel_a'], rows[0] = check_attention_level(
            args, '_bfp', 'BFP (Libra RetinaNet)')
    del args
    with phase('libra_retina: train'):
        model, start, launches_train, _, results['train'] = train(
            cfg, train_dtypes, ('bbox_head.retina_reg',
                                'bbox_head.retina_cls'))
    with phase('libra_retina: training step, card against CPU'):
        results['train_reference'] = train_reference_check(
            model, start, cfg, readings=False)
    del model
    torch.cuda.empty_cache()
    return results, launches_serve, launches_train, rows


def ohem(requests, train_dtypes):
    """Faster R-CNN + OHEM (``faster_rcnn_r50_fpn_ohem_1x_coco.py``, plain
    FPN): (a) trained (no A; B twice a step, once for the hard-mining
    forward over every candidate, once for the sampled RoIs; C once: the
    hard-mining pass builds no graph), (b) kernel B on the first step's
    hard-mining RoIs (bs2: 2 x (1000 + 16)), bit for bit, (c) a step
    against the CPU with the hard scores held and then shared, (d) served
    (B once, no A). Returns each check's result, the serving and training
    runs' launches, and the row's additions for B."""
    cfg = bench.OHEM_CFG
    results, row = {}, {}
    with phase('ohem: train'):
        model, start, launches_train, step_args, results['train'] = train(
            cfg, train_dtypes, ('fc_cls', 'fc_reg'))
    with phase('ohem: kernel B on the hard-mining RoIs'):
        feats, rois, lvls = step_args['forward'][0]
        want = 2 * (model.train_cfg['rpn_proposal']['nms_post'] + 16)
        ok = rois.shape[0] == want and len(step_args['forward']) == 2
        print(f'OHEM step: B launches {len(step_args["forward"])} over '
              f'{[a[1].shape[0] for a in step_args["forward"]]} RoIs (the '
              f'hard-mining pass over {want} expected first) '
              f'{"ok" if ok else "FAIL"}')
        for dt in (torch.bfloat16, torch.float32):
            ok = _roi_align_bit_for_bit(feats, rois, lvls, dt,
                                        'OHEM hard mining B=2',
                                        f'_ohem_r{rois.shape[0]}', row) and ok
        results['kernel_b'] = ok
    del step_args, feats
    with phase('ohem: training step, card against CPU'):
        results['train_reference'] = train_reference_check(
            model, start, cfg, readings=False)
    del model
    torch.cuda.empty_cache()
    with phase('ohem: serve'):
        model = build_detector(cfg)
        launches_serve, results['serve'], _ = serve(model, requests)
    del model
    torch.cuda.empty_cache()
    return results, launches_serve, launches_train, row


def faster_bfp(requests):
    """Faster R-CNN + BFP (``faster_rcnn_r50_fpn_bfp_1x_coco.py``: BFP at
    refine level 2 of P2-P6, stride 16, N = 4200): served (A and B once a
    request) and against the CPU. Returns each check's result and the
    serving run's launches."""
    cfg = bench.BFP_CFG
    results = {}
    with phase('bfp: serve'):
        model = build_detector(cfg, CLS_SCALE['bfp'])
        launches_serve, results['serve'], _ = serve(model, requests)
    with phase('bfp: card against CPU'):
        results['reference'] = reference_check(model, cfg)
    del model
    torch.cuda.empty_cache()
    return results, launches_serve


# --------------------------------------------------------------------------
# phases 37-50: caffe ResNet, ResNeXt, the C4 layout, Cascade Mask R-CNN
# and the mmdet 1.x coder
# --------------------------------------------------------------------------

def caffe(requests, train_dtypes, name_limit):
    """Faster R-CNN R50 caffe + FPN (``faster_rcnn_r50_caffe_fpn_1x_coco.
    py``: the stride on each stage's first 1x1 conv, BGR input): (a) served
    (no A, B once) and against the CPU; (b) trained (B and C once a step)
    and a step against the CPU; (c) the train and test CLIs on synthetic
    PNGs through its ``Normalize(to_rgb=False)`` pipeline
    (``train_and_evaluate``). Returns each check's result and the serving,
    training and evaluation runs' launches."""
    cfg = bench.CAFFE_CFG
    results = {}
    with phase('caffe: serve'):
        model = build_detector(cfg, CLS_SCALE['caffe'])
        print(f'caffe style: layer2.0 conv1 stride '
              f'{model.backbone.layer2[0].conv1.stride}, conv2 stride '
              f'{model.backbone.layer2[0].conv2.stride}')
        launches_serve, results['serve'], _ = serve(model, requests)
    with phase('caffe: card against CPU'):
        results['reference'] = reference_check(model, cfg)
    del model
    torch.cuda.empty_cache()
    with phase('caffe: train'):
        model, start, launches_train, _, results['train'] = train(
            cfg, train_dtypes, ('fc_cls', 'fc_reg'))
    with phase('caffe: training step, card against CPU'):
        results['train_reference'] = train_reference_check(
            model, start, cfg, readings=False)
    del model
    torch.cuda.empty_cache()
    with phase('caffe: train and evaluate through the CLIs'):
        results['evaluate'], launches_eval = train_and_evaluate(
            'caffe', cfg, 'build/caffe_coco', 1, name_limit, n_a=0)
    return results, launches_serve, launches_train, launches_eval


def libra_x101(requests, train_dtypes):
    """Libra R-CNN + ARFE on ResNeXt-101 64x4d (``libra_faster_rcnn_
    x101_64x4d_fpn_1x_coco.py``; its served classifier scaled,
    :data:`CLS_SCALE`): (a) served (A once at N = 1050, B once) and against
    the CPU; (b) kernel A on the requests' refine level; (c) trained (A, B
    and C once a step) and a step against the CPU, on the seeded weights.
    Returns each check's result, the serving and training runs' launches,
    and the row's additions for A."""
    cfg = bench.LIBRA_X101_CFG
    results, row = {}, {}
    with phase('libra_x101: serve'):
        model = build_detector(cfg, CLS_SCALE['libra_x101'])
        conv2 = model.backbone.layer3[0].conv2
        print(f'ResNeXt-101 64x4d: {len(model.backbone.layer3)} stage-3 '
              f'blocks, grouped conv {tuple(conv2.weight.shape)} in '
              f'{conv2.groups} groups')
        launches_serve, results['serve'], args = serve(model, requests)
    with phase('libra_x101: card against CPU'):
        results['reference'] = reference_check(model, cfg)
    del model
    torch.cuda.empty_cache()
    with phase('libra_x101: kernel A at N = 1050'):
        results['kernel_a'], row = check_attention_level(
            args, '_libra_x101', 'Libra + ARFE X101')
    del args
    with phase('libra_x101: train'):
        model, start, launches_train, _, results['train'] = train(
            cfg, train_dtypes, ('fc_reg',))
    with phase('libra_x101: training step, card against CPU'):
        results['train_reference'] = train_reference_check(
            model, start, cfg, readings=False)
    del model
    torch.cuda.empty_cache()
    return results, launches_serve, launches_train, row


def fewer_rois(path, proposals=256, samples=64):
    """The config at ``path`` with ``proposals`` training proposals an image
    and ``samples`` sampled RoIs a stage, for a step check whose CPU side
    would take most of a minute at the config's sizes: the C4 step runs
    every sampled RoI through the shared ``layer4`` (1.46 GFLOP a RoI,
    three times with its gradient)."""
    from arfe_tpu_torch.config import Config
    cfg = Config.fromfile(path)
    cfg.train_cfg['rpn_proposal'].update(nms_post=proposals,
                                         max_num=proposals)
    rcnn = cfg.train_cfg['rcnn']
    for stage in rcnn if isinstance(rcnn, list) else [rcnn]:
        stage['sampler']['num'] = samples
    return cfg


def check_roi_align_c4(args, launch, prefix, what):
    """Kernel B (:func:`_roi_align_bit_for_bit`, 14 x 14 bins on one
    stride-16 level of 1024 channels) on the arguments of each first bs1
    and bs2 request's B launch ``launch``, bf16 and f32 (the bs2 levels cast
    to f32; bs1's from the f32 request). The row's keys are
    ``{prefix}_r{R}``."""
    ok, row = True, {}
    for b in (1, 2):
        for dt in (torch.bfloat16, torch.float32):
            feats, rois, lvls = args.get((b, dt, 'launch', launch)) \
                or args[b, torch.bfloat16, 'launch', launch]
            ok = _roi_align_bit_for_bit(
                feats, rois, lvls, dt, f'{what} B={b}',
                f'{prefix}_r{rois.shape[0]}', row, (14, 14)) and ok
    return ok, row


def _forward_launch(step_args, j):
    """Kernel C's arguments in the first step for the forward's B launch
    ``j`` (autograd runs the backward in its own order)."""
    return next(a for a, f in zip(step_args['all'],
                                  step_args['forward_index']) if f == [j])


def rpn_reading(model, batch):
    """The RPN stage of a training step on ``batch``: its wall ms (median
    of 3, synchronised) and the peak memory it adds, printed; the training
    proposals' ``nms_pre`` decides the NMS problem's size. Then the card's
    choice of proposals there against the plain path's selection from the
    card's candidates (``bench.selection_faults``), which must be the same
    and fill every slot; returns whether it is."""
    cfg = model.train_cfg['rpn_proposal']
    with torch.no_grad():
        feats = model.extract_feat(batch['img'])
        shapes = batch['img_shape']
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            props, valid = model.rpn_head.get_proposals(feats, shapes, cfg)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    anchors = bench.num_anchors(model, H, W)
    print(f'C4 RPN at bs{batch["img"].shape[0]}: {anchors} anchors an image, '
          f'nms_pre {cfg["nms_pre"]}, {int(valid.sum())} proposals kept; '
          f'{sorted(times)[1]:.2f} ms wall (median of 3), '
          f'{peak:.2f} GiB peak memory over the features')
    t0 = time.time()
    with torch.no_grad():
        shared = [model.rpn_head.shared_single(f) for f in feats]
        seen = (shared, shapes, cfg) + model.rpn_head.get_proposals(
            None, shapes, cfg, shared)
    faults = bench.selection_faults(
        model.rpn_head, copy.deepcopy(model.rpn_head).cpu(), seen)
    ok = faults == 0 and bool(seen[4].all())
    print(f'C4 RPN selection at nms_pre {cfg["nms_pre"]}: the card\'s '
          f'{int(seen[4].sum())} proposals against the plain selection from '
          f'its candidates on the CPU: {faults} differ (none may; '
          f'{time.time() - t0:.1f} s) {"ok" if ok else "FAIL"}')
    return ok


def c4_mask(requests, train_dtypes):
    """Mask R-CNN C4 (``mask_rcnn_r50_caffe_c4_1x_coco.py``): (a) served
    (no A; B twice at 14 x 14 over 1024 channels: the proposals, then the
    detection slots, each through the shared ``layer4``) and against the
    CPU, mask logits included; (b) kernel B on both launches' arguments;
    (c) trained (B and C twice a step: the sampled RoIs, then the mask
    RoIs), kernel C at 1024 channels on both of the first step's
    cotangents, the RPN stage's time and memory and its selection against
    the CPU's at ``nms_pre`` 12000, and a step against the
    CPU on fewer RoIs (:func:`fewer_rois`). Returns each check's result,
    the serving and training runs' launches, and the rows' additions for
    B and C."""
    cfg = bench.C4_MASK_CFG
    results, rows = {}, [{}, {}, {}]
    with phase('c4_mask: serve'):
        model = build_detector(cfg, CLS_SCALE['c4_mask'])
        launches_serve, results['serve'], args = serve(model, requests)
    with phase('c4_mask: card against CPU'):
        results['reference'] = reference_check(model, cfg,
                                               proposals=300)
    del model
    torch.cuda.empty_cache()
    with phase('c4_mask: kernel B at 14 x 14, 1024 channels'):
        ok_p, rows[1] = check_roi_align_c4(args, 0, '_c4', 'C4 proposals')
        ok_m, more = check_roi_align_c4(args, 1, '_c4_mask',
                                        'C4 detection slots')
        rows[1].update(more)
        results['kernel_b'] = ok_p and ok_m
    del args
    with phase('c4_mask: train'):
        model, start, launches_train, step_args, results['train'] = train(
            cfg, train_dtypes, ('roi_head.shared_head.layer4.2.conv3',
                                'roi_head.mask_head.', 'fc_cls'))
    with phase('c4_mask: kernel C at 1024 channels'):
        ok = True
        for j, name in ((0, '_c4'), (1, '_c4_mask')):
            a = _forward_launch(step_args, j)
            good, row = check_roi_align_bwd_step(
                a, key=f'{name}_r{a[1].shape[0]}', plain=True)
            ok = ok and good
            rows[2].update(row)
        results['kernel_c'] = ok
    del step_args
    with phase('c4_mask: RPN stage'):
        results['rpn'] = rpn_reading(model, bench.synthetic_batch(2))
    with phase('c4_mask: training step, card against CPU'):
        results['train_reference'] = train_reference_check(
            model, start, fewer_rois(cfg), readings=False)
    del model
    torch.cuda.empty_cache()
    return results, launches_serve, launches_train, rows


def c4(requests):
    """Faster R-CNN C4 (``faster_rcnn_r50_caffe_c4_1x_coco.py``): served (no
    A, B once at 14 x 14 over 1024 channels) and against the CPU. Returns
    each check's result and the serving run's launches."""
    cfg = bench.C4_CFG
    results = {}
    with phase('c4: serve'):
        model = build_detector(cfg, CLS_SCALE['c4'])
        launches_serve, results['serve'], _ = serve(model, requests)
    with phase('c4: card against CPU'):
        results['reference'] = reference_check(model, cfg,
                                               proposals=300)
    del model
    torch.cuda.empty_cache()
    return results, launches_serve


def cascade_mask(requests, train_dtypes):
    """Cascade Mask R-CNN R50 + FPN (``cascade_mask_rcnn_r50_fpn_1x_coco.
    py``): (a) served (no A; B three times, a stage's; boxes only) and
    against the CPU; (b) kernel B on each stage's served RoIs; (c) trained
    (B and C six times a step: a stage's boxes at 7 x 7, then its mask
    RoIs at 14 x 14; every stage's mask head moves), kernel B on each
    stage's mask RoIs of the first step and kernel C on each of its six
    cotangents, keyed by stage, and a step against the CPU. Returns each
    check's result, the serving and training runs' launches, and the rows'
    additions for B and C."""
    cfg = bench.CASCADE_MASK_CFG
    results, rows = {}, [{}, {}, {}]
    with phase('cascade_mask: serve'):
        model = build_detector(cfg, CLS_SCALE['cascade_mask'])
        launches_serve, results['serve'], args = serve(model, requests)
    with phase('cascade_mask: card against CPU'):
        results['reference'] = reference_check(model, cfg)
    del model
    torch.cuda.empty_cache()
    with phase("cascade_mask: kernel B on each stage's RoIs"):
        results['kernel_b'], rows[1] = check_roi_align_stages(
            args, 3, '_cascade_mask', 'cascade mask')
    del args
    with phase('cascade_mask: train'):
        model, start, launches_train, step_args, results['train'] = train(
            cfg, train_dtypes, tuple(f'roi_head.mask_head.{i}.'
                                     for i in range(3)))
    with phase("cascade_mask: kernels B and C on each stage's mask RoIs"):
        # forward order: stage i's boxes (B launch 2i), then its mask RoIs
        # (2i + 1)
        ok = sorted(map(str, step_args['forward_index'])) == sorted(
            str([j]) for j in range(6))
        print(f"kernel C launches by forward B launch "
              f"{step_args['forward_index']} {'ok' if ok else 'FAIL'}")
        for i in range(3):
            feats, rois, lvls = step_args['forward'][2 * i + 1]
            for dt in (torch.bfloat16, torch.float32):
                ok = _roi_align_bit_for_bit(
                    feats, rois, lvls, dt, f'cascade mask stage {i} B=2',
                    f'_cascade_mask_s{i}_mask_r{rois.shape[0]}', rows[1],
                    (14, 14)) and ok
            for j, kind in ((2 * i, 'box'), (2 * i + 1, 'mask')):
                a = _forward_launch(step_args, j)
                good, row = check_roi_align_bwd_step(
                    a, key=f'_cascade_mask_s{i}_{kind}_r{a[1].shape[0]}',
                    plain=j == 1)
                ok = ok and good
                rows[2].update(row)
        results['kernels'] = ok
    del step_args
    with phase('cascade_mask: training step, card against CPU'):
        results['train_reference'] = train_reference_check(
            model, start, cfg, readings=False)
    del model
    torch.cuda.empty_cache()
    return results, launches_serve, launches_train, rows


def mask_v1(requests):
    """Mask R-CNN R50 caffe + FPN as mmdet 1.x trained it
    (``mask_rcnn_r50_caffe_fpn_poly_1x_coco_v1.py``: the legacy +1 coder in
    the RPN and the box head, RoIAlign with ``sample_num=2``): served (no
    A, B twice) and against the CPU. Returns each check's result and the
    serving run's launches."""
    cfg = bench.MASK_V1_CFG
    results = {}
    with phase('v1: serve'):
        model = build_detector(cfg, CLS_SCALE['v1'])
        print(f'coders: RPN {type(model.rpn_head.bbox_coder).__name__}, '
              f'box head {type(model.roi_head.bbox_head.bbox_coder).__name__}'
              f'; RoIAlign sample_num '
              f'{model.roi_head.bbox_roi_extractor.sample_num}')
        launches_serve, results['serve'], _ = serve(model, requests)
    with phase('v1: card against CPU'):
        results['reference'] = reference_check(model, cfg)
    del model
    torch.cuda.empty_cache()
    return results, launches_serve


# --------------------------------------------------------------------------
# phases 48-79: the RPN alone (FPN and C4) with its proposals'
# recall, FSAF, the IoU losses, FPNBU, FPNRelation, FPNCBAM, AttRoIs, and
# VisDrone through the CLIs
# --------------------------------------------------------------------------

def _rpn_candidates_close(model, cpu, img):
    """The RPN's per-level candidate logits and regressions on the card
    against the CPU's on ``img``: the largest difference over each one's
    largest |value|; and the card's shared features."""
    with torch.no_grad():
        shared = [model.rpn_head.shared_single(f)
                  for f in model.extract_feat(img.cuda())]
        cpu_shared = [cpu.rpn_head.shared_single(f)
                      for f in cpu.extract_feat(img)]
        errs = [((a.cpu() - b).abs().max() / b.abs().max()).item()
                for g, c in zip(bench.rpn_candidates(model.rpn_head, shared),
                                bench.rpn_candidates(cpu.rpn_head,
                                                     cpu_shared))
                for a, b in zip(g[:2], c[:2])]
    return max(errs), shared


def rpn_reference_check(model, cfg):
    """The RPN served on the card against the same weights on the CPU on a
    f32 (1, 320, 480, 3) image: each level's candidate logits and
    regressions within 1e-4 of their scale; every slot filled on both; and
    the card's proposals the plain selection (top ``nms_pre`` a level,
    decode, NMS, top ``nms_post``, on the CPU) from the card's own
    candidates (``bench.selection_faults``: none may differ). How many of
    the CPU's proposals the card's lacks is printed: at random weights the
    objectness scores crowd, and a top-k or NMS flip among scores that tie
    within f32 rounding is not a fault (``PERF.md`` §7)."""
    from arfe_tpu_torch.apis import init_detector
    cpu = init_detector(cfg, device='cpu')
    cpu.load_state_dict(model.state_dict())
    img = torch.randn((1, 320, 480, 3),
                      generator=torch.Generator().manual_seed(3)) * 0.2
    shapes, scales = torch.tensor([[320.0, 470.0]]), torch.ones(1, 4)
    err, shared = _rpn_candidates_close(model, cpu, img)
    want = cpu.simple_test(img, shapes, scales)
    got = model.simple_test(img.cuda(), shapes.cuda(), scales.cuda())
    faults = bench.selection_faults(model.rpn_head, cpu.rpn_head, (
        shared, shapes.cuda(), model.rpn_head.test_cfg, *got))
    lacks = bench.unmatched(*want, *got)
    ok = err <= 1e-4 and faults == 0 and bool(got[1].all()) \
        and bool(want[1].all())
    print(f'reference (CPU plain path, 320x480 f32): candidates rel err '
          f'{err:.2e} (tol 1e-4); {int(got[1].sum())} proposals on the card, '
          f'{int(want[1].sum())} on the CPU; the card\'s against the plain '
          f'selection from its own candidates: {faults} differ (none may); '
          f'of the CPU\'s the card\'s lacks {lacks} {"ok" if ok else "FAIL"}')
    return ok


def rpn_recall_check(model, cfg, root='build/rpn_coco'):
    """The proposals' average recall on the card and on the CPU: one f32
    request at 800x1344 (1000 proposals) on each, rescaled by 1.25; a COCO
    set of that image (written under ``root``) whose gts are 12 of the
    CPU's proposals jittered by up to 4 px and 4 random boxes;
    ``CocoDataset.evaluate('proposal_fast')`` of each side's proposals.
    Each ``AR@n`` within 1e-6 plus the share of gts that the proposals of
    either side's first n that the other's first n lack could move (one
    each). Returns whether they were."""
    from arfe_tpu_torch.apis import init_detector
    from arfe_tpu_torch.config import Config
    from arfe_tpu_torch.data import build_dataset, synthetic
    cpu = init_detector(cfg, device='cpu')
    cpu.load_state_dict(model.state_dict())
    img = torch.randn((1, H, W, 3),
                      generator=torch.Generator().manual_seed(7)) * 0.2
    shapes = torch.tensor([IMG_SHAPE])
    scales = torch.full((1, 4), 1.25)
    t0 = time.time()
    want = [t[0] for t in cpu.simple_test(img, shapes, scales, True)]
    cpu_s = time.time() - t0
    got = [t[0].cpu() for t in model.simple_test(
        img.cuda(), shapes.cuda(), scales.cuda(), True)]
    rng = np.random.RandomState(5)
    w, h = IMG_SHAPE[1] / 1.25, IMG_SHAPE[0] / 1.25
    props = want[0][want[1]].numpy()
    picked = props[rng.permutation(len(props))[:12], :4] \
        + rng.uniform(-4, 4, (12, 4))
    xy = rng.uniform(0, [w - 200, h - 200], (4, 2))
    boxes = np.concatenate([picked, np.concatenate(
        [xy, xy + rng.uniform(20, 200, (4, 2))], 1)])
    boxes = np.clip(boxes, 0, [w, h, w, h])
    anns = [dict(id=k + 1, image_id=1, category_id=1,
                 bbox=[float(b[0]), float(b[1]), float(b[2] - b[0]),
                       float(b[3] - b[1])],
                 area=float((b[2] - b[0]) * (b[3] - b[1])), iscrowd=0)
            for k, b in enumerate(boxes) if b[2] - b[0] > 1
            and b[3] - b[1] > 1]
    os.makedirs(root, exist_ok=True)
    synthetic.write_annotations(f'{root}/ann.json', [dict(
        id=1, width=int(w), height=int(h), file_name='0.png')], anns)
    dataset = build_dataset(dict(
        type='CocoDataset', ann_file=f'{root}/ann.json',
        img_prefix=f'{root}/', pipeline=Config.fromfile(cfg).data.test
        .pipeline), dict(test_mode=True))
    nums = (100, 300, 1000)
    ar = {side: dataset.evaluate([[p[0][p[1]].numpy()]],
                                 metric='proposal_fast', proposal_nums=nums)
          for side, p in (('cpu', want), ('card', got))}

    def first(p, n):
        d, v = p[0][p[1]], p[1][p[1]]
        order = torch.argsort(-d[:, 4], stable=True)[:n]
        return d[order][None], v[order][None]
    ok = True
    for n in nums:
        a, b = first(want, n), first(got, n)
        moved = max(bench.unmatched(*a, *b), bench.unmatched(*b, *a))
        tol = 1e-6 + moved / len(anns)
        diff = abs(ar['cpu'][f'AR@{n}'] - ar['card'][f'AR@{n}'])
        ok = ok and diff <= tol
        print(f'proposal recall AR@{n}: CPU {ar["cpu"][f"AR@{n}"]:.6f}, card '
              f'{ar["card"][f"AR@{n}"]:.6f}, difference {diff:.2e} (tol '
              f'1e-6 + {moved} of the first {n} differing / {len(anns)} gts)')
    ok = ok and ar['cpu']['AR@1000'] > 0.2
    print(f'proposal recall, card f32 against the CPU plain path at '
          f'{W}x{H} ({cpu_s:.1f} s on the CPU), {len(anns)} gts '
          f'{"ok" if ok else "FAIL"}')
    return ok


def rpn(requests, c4_requests, train_dtypes):
    """The RPN alone (``configs/rpn/rpn_r50_fpn_1x_coco.py``): (a) served
    (no A, no B; 1000 proposals an image) and against the CPU
    (:func:`rpn_reference_check`), the proposals' recall against the CPU's
    (:func:`rpn_recall_check`); (b) trained (no kernel: class-agnostic
    anchor losses) and a step against the CPU; (c) its C4 form
    (``rpn_r50_caffe_c4_1x_coco.py``: one stride-16 level, ``nms_pre``
    12000, 2000 proposals) served and against the CPU. Returns each check's
    result and the serving, training and C4 serving runs' launches."""
    cfg = bench.RPN_CFG
    results = {}
    with phase('rpn: serve'):
        model = build_detector(cfg)
        launches_serve, results['serve'], _ = serve(model, requests)
    with phase('rpn: card against CPU'):
        results['reference'] = rpn_reference_check(model, cfg)
    with phase('rpn: proposal recall, card against CPU'):
        results['recall'] = rpn_recall_check(model, cfg)
    del model
    torch.cuda.empty_cache()
    with phase('rpn: train'):
        model, start, launches_train, _, results['train'] = train(
            cfg, train_dtypes, ('rpn_head.rpn_cls', 'rpn_head.rpn_reg'))
    with phase('rpn: training step, card against CPU'):
        results['train_reference'] = train_reference_check(
            model, start, cfg, readings=False)
    del model
    torch.cuda.empty_cache()
    with phase('rpn c4: serve'):
        model = build_detector(bench.RPN_C4_CFG)
        launches_c4, results['c4_serve'], _ = serve(model, c4_requests)
    with phase('rpn c4: card against CPU'):
        results['c4_reference'] = rpn_reference_check(model,
                                                      bench.RPN_C4_CFG)
    del model
    torch.cuda.empty_cache()
    return results, launches_serve, launches_train, launches_c4


def fsaf(requests, train_dtypes):
    """FSAF (``configs/fsaf/fsaf_r50_fpn_1x_coco.py``): (a) served (no A,
    no B) and against the CPU; (b) trained (no kernel; the online level
    choice's ``gt_assign_hist`` held exactly against the CPU's in the step
    check) and a step against the CPU. Returns each check's result and the
    serving and training runs' launches."""
    cfg = bench.FSAF_CFG
    results = {}
    with phase('fsaf: serve'):
        model = build_detector(cfg, CLS_SCALE['fsaf'])
        launches_serve, results['serve'], _ = serve(model, requests)
    with phase('fsaf: card against CPU'):
        results['reference'] = reference_check(model, cfg)
    del model
    torch.cuda.empty_cache()
    with phase('fsaf: train'):
        model, start, launches_train, _, results['train'] = train(
            cfg, train_dtypes, ('bbox_head.retina_reg',
                                'bbox_head.retina_cls'))
    with phase('fsaf: training step, card against CPU'):
        results['train_reference'] = train_reference_check(
            model, start, cfg, readings=False)
    del model
    torch.cuda.empty_cache()
    return results, launches_serve, launches_train


class _KeepLossInputs:
    """A box loss that keeps the arguments of its first call."""

    def __init__(self, loss):
        self.loss, self.kept = loss, None

    def __call__(self, pred, target, weight=None, **kwargs):
        if self.kept is None:
            self.kept = (pred.detach().clone(), target.detach().clone(),
                         weight.detach().clone(), kwargs.get('avg_factor'))
        return self.loss(pred, target, weight, **kwargs)


def iou_losses_on_step(kept):
    """``IoULoss`` and ``BoundedIoULoss`` (the IoU-loss configs' weight 10)
    and their gradients with respect to the predictions on the GIoU step's
    RoI head inputs (its sampled RoIs' class-selected deltas and targets,
    which the JAX package's head and the port's compare as boxes: their
    ``reg_decoded_bbox`` is not read), on the card and on the CPU: each
    loss within rtol 1e-4, each gradient within 1e-4 + 1e-3 of the
    largest."""
    from arfe_tpu_torch.models.losses import BoundedIoULoss, IoULoss
    pred, target, weight, avg = kept
    ok = True
    for loss in (IoULoss(loss_weight=10.0), BoundedIoULoss(loss_weight=10.0),
                 ):
        vals, grads = [], []
        for dev in ('cuda', 'cpu'):
            p = pred.detach().to(dev).float().requires_grad_()
            v = loss(p, target.to(dev), weight.to(dev), avg_factor=avg)
            v.backward()
            vals.append(float(v.detach()))
            grads.append(p.grad.cpu())
        err = abs(vals[0] - vals[1]) / max(abs(vals[1]), 1e-12)
        gerr = (grads[0] - grads[1]).abs().max().item()
        gtol = 1e-4 + 1e-3 * grads[1].abs().max().item()
        good = err <= 1e-4 and gerr <= gtol and np.isfinite(vals[0])
        ok = ok and good
        print(f'{type(loss).__name__} on the GIoU step\'s {pred.shape[0]} '
              f'sampled RoIs ({int((weight.sum(-1) > 0).sum())} positive): '
              f'card {vals[0]:.6f}, CPU {vals[1]:.6f}, rel err {err:.2e} (tol '
              f'1e-4); gradient max abs err {gerr:.2e} (tol {gtol:.2e}) '
              f'{"ok" if good else "FAIL"}')
    return ok


def faster_family(name, cfg, requests, train_dtypes, must_move, batch=1,
                  losses_kept=False):
    """A Faster R-CNN R50 + FPN variant (``cfg``): (a) served (no A, B once
    a request: over the proposals, or over an AR-RFF head's 3P triple
    RoIs) and against the CPU on a batch of ``batch``; (b) kernel B on the
    first bs1 and bs2 requests' RoIs, bit for bit in bf16 and f32; (c)
    trained (B and C once a step), kernel C on the first step's cotangent
    and RoIs, and a step against the CPU; with ``losses_kept`` (the GIoU
    detector), IoU and bounded IoU on that step's RoI head inputs
    (:func:`iou_losses_on_step`). Returns each check's result, the serving
    and training runs' launches, and the rows' additions for B and C."""
    results, rows = {}, [{}, {}, {}]
    with phase(f'{name}: serve'):
        model = build_detector(cfg, CLS_SCALE[name])
        launches_serve, results['serve'], args = serve(model, requests)
    with phase(f'{name}: card against CPU'):
        results['reference'] = reference_check(model, cfg, batch)
    del model
    torch.cuda.empty_cache()
    with phase(f'{name}: kernel B on the requests\' RoIs'):
        results['kernel_b'], rows[1] = check_roi_align_stages(
            args, 1, f'_{name}', name)
    del args
    kept = {}

    def keep_loss_inputs(model):
        head = model.roi_head.bbox_head
        kept['loss'] = head.loss_bbox = _KeepLossInputs(head.loss_bbox)
    with phase(f'{name}: train'):
        model, start, launches_train, step_args, results['train'] = train(
            cfg, train_dtypes, must_move,
            prepare=keep_loss_inputs if losses_kept else None)
    with phase(f'{name}: kernel C on a step\'s RoIs'):
        a = step_args['all'][0]
        results['kernel_c'], rows[2] = check_roi_align_bwd_step(
            a, key=f'_{name}_r{a[1].shape[0]}')
    del step_args
    if losses_kept:
        head = model.roi_head.bbox_head
        head.loss_bbox = kept['loss'].loss
        with phase(f'{name}: IoU and bounded IoU on a step\'s RoIs'):
            results['iou_losses'] = iou_losses_on_step(kept['loss'].kept)
    with phase(f'{name}: training step, card against CPU'):
        results['train_reference'] = train_reference_check(
            model, start, cfg, readings=False)
    del model
    torch.cuda.empty_cache()
    return results, launches_serve, launches_train, rows


VISDRONE_ROOT = 'build/visdrone_coco'


def visdrone(name_limit):
    """The VisDrone "+fac" detector (``configs/mytrain/faster_rcnn_r50_fpn_
    multicls_1x_visdrone.py``: 12 classes, the config's mean and std) through
    the CLIs: 8 box PNGs labelled with VisDrone's categories under
    ``VISDRONE_ROOT``, its ``data.train`` the list of two sets of four of
    them (a ``ConcatDataset``), two images a batch (the config's one) and
    the gradient clipped at norm 35 (the config clips nothing: at random
    weights its "+fac" head's ``loss_cls`` starts in the hundreds and the
    run reached NaN by its fifth iteration at bs1 on the card and its
    fourth at bs2 on the CPU); one epoch of 4 iterations through the train
    CLI and
    the test CLI with ``--eval bbox`` (:func:`train_and_evaluate`:
    B and C once an iteration, B once an evaluated image); kernel B on the
    first evaluated image's RoIs bit for bit, C on the first iteration's
    cotangent within 1e-5. Returns whether all held, the evaluation's
    launches and the rows' additions for B and C."""
    from arfe_tpu_torch.config import Config
    from arfe_tpu_torch.data import VisdroneDataset
    cats = [dict(id=i + 1, name=n)
            for i, n in enumerate(VisdroneDataset.CLASSES)]
    root = os.path.abspath(VISDRONE_ROOT)
    base = Config.fromfile(bench.VISDRONE_CFG).todict()['data']['train']
    train_sets = []
    for half in ('a', 'b'):
        train_sets.append(dict(base[0], ann_file=f'{root}/ann_{half}.json',
                               img_prefix=f'{root}/imgs/'))
    cfg_path = f'{root}/visdrone_cfg.py'
    kernels = {}

    def split(images, anns):
        # the config, and its two train sets: the first four images and
        # the last four (after train_and_evaluate has emptied the root)
        from arfe_tpu_torch.data import synthetic
        with open(cfg_path, 'w') as f:
            f.write(f"_base_ = ['{os.path.abspath(bench.VISDRONE_CFG)}']\n"
                    f"data = dict(samples_per_gpu=2, train={train_sets!r})\n"
                    "optimizer_config = dict(grad_clip=dict(max_norm=35, "
                    "norm_type=2))\n")
        for half, (lo, hi) in (('a', (0, 4)), ('b', (4, 8))):
            ids = {img['id'] for img in images[lo:hi]}
            synthetic.write_annotations(
                f'{root}/ann_{half}.json', images[lo:hi],
                [a for a in anns if a['image_id'] in ids], cats)
    ok, launches = train_and_evaluate(
        'visdrone', cfg_path, VISDRONE_ROOT, 1, name_limit, n_a=0,
        categories=cats, splits=('val', 'test'), kernels=kernels,
        before_train=split)
    rows = [{}, {}, {}]
    feats, rois, lvls = kernels['b']
    for dt in (torch.bfloat16, torch.float32):
        ok = _roi_align_bit_for_bit(
            feats, rois, lvls, dt, 'VisDrone evaluated image',
            f'_visdrone_r{rois.shape[0]}', rows[1]) and ok
    good, rows[2] = check_roi_align_bwd_step(
        kernels['c'], key=f'_visdrone_r{kernels["c"][1].shape[0]}')
    return ok and good, launches, rows


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
            model, [(1, bf)] * 2 + [(2, bf), (1, f32)])
    with phase('flagship: card against CPU'):
        ok_ref = reference_check(model)
    del model
    torch.cuda.empty_cache()
    with phase('flagship: train'):
        model, start, launches, step_args, ok_train = train(
            dtypes=(bf, bf, f32))
    with phase('flagship: kernel C on a step\'s RoIs'):
        ok_step_rois, row_step = check_roi_align_bwd_step(step_args[7])
    rows[2].update(row_step)
    del step_args
    with phase('flagship: training step, card against CPU'):
        ok_train_ref = train_reference_check(model, start)
    del model
    torch.cuda.empty_cache()
    arrff = arfe('arrff', [(1, bf), (2, bf), (1, f32)], [bf, f32],
                 ('hh_conv', 'wh_conv', 'final_conv'))
    rows[1].update(arrff[3][0])
    rows[2].update(arrff[3][1])
    # at random weights the "+fac" presence logits saturate: its
    # loss_multi_cls reads 1 + tanh(1) and can pass no gradient
    fac = arfe('fac', [(1, bf)], [bf], ())
    with phase('arrff: evaluate'):
        ok_eval, launches_eval, eval_rows = evaluate_arrff()
    rows[0].update(eval_rows[0])
    rows[1].update(eval_rows[1])
    with phase('arrff: train run'):
        ok_train_run, launches_train_run, train_run_row = train_run_arrff(
            name_limit)
    rows[0].update(train_run_row)
    mask = mask_rcnn([(1, bf), (2, bf), (1, f32)], [bf, f32])
    rows[1].update(mask[3][0])
    rows[2].update(mask[3][1])
    with phase('mask: train and evaluate through the CLIs'):
        ok_mask_eval, launches_mask_eval, mask_row = evaluate_mask(name_limit)
    rows[0].update(mask_row)
    cascade = cascade_rcnn([(1, bf), (2, bf), (1, f32)], [bf, f32])
    rows[1].update(cascade[3][1])
    rows[2].update(cascade[3][2])
    with phase('cascade: train and evaluate through the CLIs'):
        ok_cascade_eval, launches_cascade_eval = train_and_evaluate(
            'cascade', CASCADE_PORT_CFG, 'build/cascade_coco', 3, name_limit)
    retina = retinanet([(1, bf), (2, bf), (1, f32)], [bf, f32])
    rows[0].update(retina[3][0])
    with phase('retina: train and evaluate through the CLIs'):
        ok_retina_eval, launches_retina_eval = train_and_evaluate(
            'retina', RETINA_PORT_CFG, 'build/retina_coco', 0, name_limit)
    libra_r50 = libra([(1, bf), (2, bf), (1, f32)], [bf, f32], name_limit)
    for row, more in zip(rows, libra_r50[3]):
        row.update(more)
    libra_r101 = libra101([bf])
    libra_ret = libra_retina([(1, bf), (2, bf), (1, f32)], [bf, f32])
    rows[0].update(libra_ret[3][0])
    ohem_runs = ohem([(1, bf), (2, bf)], [bf, f32])
    rows[1].update(ohem_runs[3])
    bfp = faster_bfp([(1, bf), (2, bf)])
    caffe_runs = caffe([(1, bf), (2, bf), (1, f32)], [bf, f32], name_limit)
    x101 = libra_x101([(1, bf), (2, bf), (1, f32)], [bf, f32])
    rows[0].update(x101[3])
    c4_mask_runs = c4_mask([(1, bf), (2, bf), (1, f32)], [bf, f32])
    for row, more in zip(rows, c4_mask_runs[3]):
        row.update(more)
    c4_runs = c4([(1, bf), (2, bf), (1, f32)])
    cmask = cascade_mask([(1, bf), (2, bf), (1, f32)], [bf, f32])
    for row, more in zip(rows, cmask[3]):
        row.update(more)
    v1 = mask_v1([(1, bf)])
    served = [(1, bf), (2, bf), (1, f32)]
    rpn_runs = rpn(served, [(1, bf), (1, f32)], [bf, f32])
    fsaf_runs = fsaf(served, [bf, f32])
    slice12 = {
        'giou': faster_family('giou', bench.GIOU_CFG, served, [bf, f32],
                              ('fc_reg',), losses_kept=True),
        'fpnbu': faster_family('fpnbu', bench.FPNBU_CFG, served, [bf, f32],
                               ('neck.0.bu_convs', 'neck.0.compress_convs')),
        'relation': faster_family('relation', bench.RELATION_CFG, served,
                                  [bf, f32], ()),
        'cbam': faster_family('cbam', bench.CBAM_CFG, served, [bf, f32],
                              ('neck.0.cbam_convs.0.channel', 'hh_conv')),
        'att': faster_family('att', bench.ATT_CFG, served + [(2, f32)],
                             [bf, f32], ('channel_reduction', 'fc1'),
                             batch=2)}
    for runs in slice12.values():
        rows[1].update(runs[3][1])
        rows[2].update(runs[3][2])
    with phase('visdrone: train and evaluate through the CLIs'):
        ok_visdrone, launches_visdrone, visdrone_rows = visdrone(name_limit)
    rows[1].update(visdrone_rows[1])
    rows[2].update(visdrone_rows[2])
    for row in rows:
        row['launches'] = launches[row['name']]
        row['launches_serve'] = launches_serve.get(row['name'], 0)
        for name, (_, serve_runs, train_runs, _) in (('arrff', arrff),
                                                      ('fac', fac)):
            row[f'launches_{name}_serve'] = serve_runs.get(row['name'], 0)
            row[f'launches_{name}_train'] = train_runs[row['name']]
        row['launches_arrff_eval'] = launches_eval[row['name']]
        row['launches_arrff_trainrun'] = launches_train_run[row['name']]
        row['launches_mask_serve'] = mask[1].get(row['name'], 0)
        row['launches_mask_train'] = mask[2][row['name']]
        row['launches_mask_eval'] = launches_mask_eval[row['name']]
        for name, runs, evaluated in (
                ('cascade', cascade, launches_cascade_eval),
                ('retina', retina, launches_retina_eval)):
            row[f'launches_{name}_serve'] = runs[1].get(row['name'], 0)
            row[f'launches_{name}_train'] = runs[2][row['name']]
            row[f'launches_{name}_eval'] = evaluated[row['name']]
        for name, runs in (('libra', libra_r50), ('libra101', libra_r101),
                           ('libra_retina', libra_ret), ('ohem', ohem_runs),
                           ('bfp', bfp), ('caffe', caffe_runs),
                           ('libra_x101', x101), ('c4_mask', c4_mask_runs),
                           ('c4', c4_runs), ('cascade_mask', cmask),
                           ('v1', v1)):
            row[f'launches_{name}_serve'] = runs[1].get(row['name'], 0)
            if len(runs) > 2:
                row[f'launches_{name}_train'] = runs[2][row['name']]
        row['launches_libra_eval'] = libra_r50[4][row['name']]
        row['launches_caffe_eval'] = caffe_runs[3][row['name']]
        for name, runs in (('rpn', rpn_runs), ('fsaf', fsaf_runs),
                           *slice12.items()):
            row[f'launches_{name}_serve'] = runs[1].get(row['name'], 0)
            row[f'launches_{name}_train'] = runs[2][row['name']]
        row['launches_rpn_c4_serve'] = rpn_runs[3].get(row['name'], 0)
        row['launches_visdrone_eval'] = launches_visdrone[row['name']]
    failed = [k for k, v in (('kernels', ok_kernels), ('serve', ok_serve),
                             ('reference', ok_ref), ('train', ok_train),
                             ('kernel C on a step', ok_step_rois),
                             ('train reference', ok_train_ref),
                             ('arrff evaluate', ok_eval),
                             ('arrff train run', ok_train_run),
                             ('mask evaluate', ok_mask_eval),
                             ('cascade evaluate', ok_cascade_eval),
                             ('retina evaluate', ok_retina_eval),
                             ('visdrone', ok_visdrone)) if not v]
    failed += [f'{name} {k}' for name, r in (('arrff', arrff), ('fac', fac),
                                             ('mask', mask),
                                             ('cascade', cascade),
                                             ('retina', retina),
                                             ('libra', libra_r50),
                                             ('libra101', libra_r101),
                                             ('libra_retina', libra_ret),
                                             ('ohem', ohem_runs),
                                             ('bfp', bfp),
                                             ('caffe', caffe_runs),
                                             ('libra_x101', x101),
                                             ('c4_mask', c4_mask_runs),
                                             ('c4', c4_runs),
                                             ('cascade_mask', cmask),
                                             ('v1', v1), ('rpn', rpn_runs),
                                             ('fsaf', fsaf_runs),
                                             *slice12.items())
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
