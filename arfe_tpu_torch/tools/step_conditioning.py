"""How well an f32 training step is conditioned: the tiny Cascade R-CNN's,
or a full-width config's.

    python -m arfe_tpu_torch.tools.step_conditioning [--device cpu]
        [--config PATH]

Takes one training step of the tiny Cascade R-CNN (R18, 64 channels, the
form of ``tests/test_torch_gpu.py``), or with ``--config`` of that config's
detector at full width on the step ``chip_smoke.py`` holds against the CPU
(the trainer's seeded starting weights, ``bench.build_trainer``, and a
2 x 320 x 480 batch of seed 6), three times on the same weights, batch
and sampling priorities: on the card in f32, on the CPU in f32 (the plain
paths) and on the CPU in f64 (the detector cast to float64, the AR-FPN
attention computed in float64; RoIAlign's plain version and the losses
keep their f32 arithmetic). For each pair it prints the largest gradient
difference of a tensor over that tensor's largest |g| in f64, the tensor
where it falls, and the same for ``neck.1.reduce_convs.0.conv.weight``.
Where the card's f32 stays near the f64 and the CPU's f32 does not, the
CPU's f32 step is what strays; where both f32 steps stray alike, the step
itself is ill-conditioned; where only the card strays, the card is at
fault.

The tiny forms: the weights that serve the card test's requests (AR-FPN's
``conv_out`` drawn, every stage's ``fc_cls`` weights scaled until the
test image gets 10 to 99 detections) with the batches of seeds 3 and 4,
and the seeded weights of the card test's training step with the batch of
seed 3. Then each pair is read again with both steps fed the f64 step's
proposals (without their gradient): a difference that goes away there came
from the RPN's choice of proposals (a top-k or NMS flip), one that stays
from the step after it. Without a card (``--device cpu``) only the CPU's
columns print. Prints the card's name and power limit, a line per form and
one JSON line.
"""
from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from ..apis import init_detector
from ..config import Config
from ..models.roi_heads import cascade_roi_head, standard_roi_head
from ..ops import non_local
from ..train import bench

#: an AR-FPN attention-map conv, whose gradient the read names (where the
#: detector has one)
TENSOR = 'neck.1.reduce_convs.0.conv.weight'
#: the full-width step of ``chip_smoke.py``'s card-against-CPU check: the
#: trainer's starting weights and a (2, 320, 480) batch of this seed, the
#: samplers' draws fixed with ``bench.fix_priorities``' default seed
FULL_HW, FULL_BATCH_SEED, FULL_DRAW_SEED = (320, 480), 6, 5


def tiny_cascade_config():
    """Cascade R-CNN at R18 and 64 channels, 64 proposals served, each
    stage's head at 64 channels and 128-wide FCs."""
    cfg = Config.fromfile(bench.CASCADE_CFG)
    mc = cfg.model
    mc.backbone.depth = 18
    mc.neck[0].update(in_channels=[64, 128, 256, 512], out_channels=64)
    mc.neck[1].in_channels = 64
    mc.rpn_head.update(in_channels=64, feat_channels=64)
    cfg.test_cfg.rpn.update(nms_pre=100, nms_post=64, max_num=64)
    mc.roi_head.bbox_roi_extractor.out_channels = 64
    for head in mc.roi_head.bbox_head:
        head.update(in_channels=64, fc_out_channels=128)
    return cfg


def spread_classifiers(cpu, weights, img):
    """Seeds the AR-FPN ``conv_out`` of the CPU model and scales its
    classifier ``weights`` (the biases kept) by the first factor, rising by
    15% from 10, at which ``img`` gets 10 to 99 detections: at random
    weights the scores crowd just under the threshold. Returns the CPU's
    detections."""
    with torch.no_grad():
        cpu.neck[1].refine.conv_out.conv.weight.normal_(
            0, 0.02, generator=torch.Generator().manual_seed(1))
    shapes, scales = torch.tensor([[192., 250.]]), torch.ones(1, 4)
    applied = 1.0
    for i in range(40):
        factor = 10.0 * 1.15 ** i
        with torch.no_grad():
            for w in weights:
                w.mul_(factor / applied)
        applied = factor
        want = cpu.simple_test(img, shapes, scales)
        if 10 <= int(want[2].sum()) < 100:
            return want
    raise AssertionError('no classifier scale gives 10 to 99 detections')


def _attention_f64(q, k, v, scale=None):
    s = q @ k.transpose(-1, -2)
    return torch.softmax(s if scale is None else s * scale, -1) @ v


def _step(model, batch, seed, proposals=None):
    """``bench.loss_and_grads`` of ``model``, and for each AR-FPN
    attention-map conv (``neck.1.reduce_convs*``, a 3x3 conv to one channel
    before a ReLU) its input, its output and the output's gradient, in
    float64 on the CPU, and the RPN's proposals (``proposals``, the
    (boxes, valid) of another step, taken in their place and without a
    gradient)."""
    seen, handles = {}, []
    get_proposals = model.rpn_head.get_proposals

    def keep_proposals(*args, **kwargs):
        out = get_proposals(*args, **kwargs)
        seen['proposals'] = [t.detach().cpu() for t in out[:2]]
        if proposals is None:
            return out
        return (proposals[0].to(out[0]), proposals[1].to(out[1].device)) \
            + tuple(out[2:])
    model.rpn_head.get_proposals = keep_proposals

    def keep(name):
        def hook(module, inputs, out):
            rec = seen[name] = {'x': inputs[0].detach().double().cpu(),
                                'pre': out.detach().double().cpu()}
            out.register_hook(lambda g: rec.update(g=g.double().cpu()))
        return hook
    for name, m in model.named_modules():
        if name.startswith('neck.1.reduce_convs') and name.endswith('.conv'):
            handles.append(m.register_forward_hook(keep(name)))
    # each stage's candidates, their assigned gts and their largest IoUs
    assign, seen['stages'] = cascade_roi_head.assign_candidates, []

    def keep_assign(*args, **kwargs):
        out = assign(*args, **kwargs)
        seen['stages'].append([t.detach().double().cpu() for t in out])
        return out
    cascade_roi_head.assign_candidates = keep_assign
    standard_roi_head.assign_candidates = keep_assign
    try:
        return bench.loss_and_grads(model, batch, seed), seen
    finally:
        cascade_roi_head.assign_candidates = assign
        standard_roi_head.assign_candidates = assign
        del model.rpn_head.get_proposals
        for h in handles:
            h.remove()


def _f64_step(cfg, cpu, batch, seed, proposals=None):
    """:func:`_step` of a float64 copy of ``cpu``."""
    model = init_detector(cfg, device='cpu', train=True)
    model.load_state_dict(cpu.state_dict())
    model.double()
    attention = non_local.fused_softmax_attention
    non_local.fused_softmax_attention = _attention_f64
    try:
        return _step(model, dict(batch, img=batch['img'].double()), seed,
                     proposals)
    finally:
        non_local.fused_softmax_attention = attention


def _gate_flips(ref, other):
    """For each attention-map conv whose weight gradient differs between
    the steps ``ref`` and ``other`` by more than 1e-3 of its largest:
    the positions whose ReLU gate differs, the largest |output| of ``ref``
    there over its largest anywhere, and the weight gradient's difference
    (over its largest in ``ref``) before and after adding to ``ref``'s
    what each such position gives ``other``'s: its output gradient times
    its 3 x 3 input patch, with the sign of the gate that opened."""
    (_, g_ref), seen_ref = ref
    (_, g_other), seen_other = other
    out = {}
    for name, r in seen_ref.items():
        if name in ('stages', 'proposals'):
            continue
        key = name + '.weight'
        gr, go = g_ref[key].double(), g_other[key].double()
        scale = gr.abs().max().item()
        err = (go - gr).abs().max().item() / max(scale, 1e-300)
        if err <= 1e-3:
            continue
        o = seen_other[name]
        on_r, on_o = r['pre'] > 0, o['pre'] > 0
        flip = on_r != on_o
        # the gradient after the ReLU, from the side whose gate is open
        d_post = torch.where(on_r, r['g'], o['g'])
        d = torch.where(flip, torch.where(on_o, d_post, -d_post), 0.0)
        cols = F.unfold(r['x'], 3, padding=1)
        fix = (cols * d.flatten(1)[:, None]).sum((0, 2)).reshape(gr.shape)
        margin = r['pre'].abs()[flip].max().item() / r['pre'].abs().max() \
            .item() if bool(flip.any()) else 0.0
        out[key] = dict(flips=int(flip.sum()), margin=margin, err=err,
                        err_flips_added=(go - gr - fix).abs().max().item()
                        / max(scale, 1e-300))
    return out


def _candidate_flips(ref, other):
    """For each cascade stage, the candidates (gts and proposals, or the
    previous stage's regressed samples) whose box moves by more than 0.01
    pixel between the steps ``ref`` and ``other``, and of the rest those
    assigned otherwise, with ``ref``'s IoU of each with its nearest gt."""
    out = []
    for (b_r, a_r, iou_r), (b_o, a_o, _) in zip(ref[1]['stages'],
                                                 other[1]['stages']):
        moved = (b_r - b_o).abs().amax(-1) > 1e-2
        other_gt = ~moved & (a_r != a_o)
        out.append(dict(moved=int(moved.sum()),
                        reassigned=int(other_gt.sum()),
                        ious=[round(v, 6) for v in
                              iou_r[other_gt].tolist()[:6]]))
    return out


def _errors(ref, other):
    """(largest difference over the tensor's largest |g| in ``ref``, its
    tensor) over every gradient, that of ``TENSOR``, :func:`_gate_flips`,
    the largest relative difference of a loss, and
    :func:`_candidate_flips`."""
    (_, g_ref), (_, g_other) = ref[0], other[0]
    losses, worst = bench.differences(ref[0], other[0])
    tensor = float('nan') if TENSOR not in g_ref else (
        (g_ref[TENSOR] - g_other[TENSOR]).abs().max().item()
        / g_ref[TENSOR].abs().max().item())
    return (worst, tensor, _gate_flips(ref, other), max(losses.values()),
            _candidate_flips(ref, other))


def full_width_form(path):
    """The form of a full-width config: (name, CPU model in f32 with
    train_cfg and the trainer's starting weights, batch seed)."""
    model = bench.build_trainer(path, device='cpu')[0]
    return [(f'{path}: the trainer\'s starting weights, batch seed '
             f'{FULL_BATCH_SEED}', model, FULL_BATCH_SEED)]


def forms():
    """(name, CPU model in f32 with train_cfg, batch seed) of each tiny
    form."""
    cfg = tiny_cascade_config()
    serving = init_detector(cfg, device='cpu', train=True)
    img = torch.randn((1, 192, 256, 3),
                      generator=torch.Generator().manual_seed(0)) * 0.2
    spread_classifiers(serving, [h.fc_cls.weight
                                 for h in serving.roi_head.bbox_head], img)
    torch.manual_seed(0)
    seeded = init_detector(cfg, device='cpu', train=True)
    with torch.no_grad():
        seeded.neck[1].refine.conv_out.conv.weight.normal_(0, 0.02)
    return [('serving weights, batch seed 3', serving, 3),
            ('serving weights, batch seed 4', serving, 4),
            ('seeded step weights, batch seed 3', seeded, 3)]


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--config', default=None,
                        help='a full-width config instead of the tiny '
                        'Cascade R-CNN')
    args = parser.parse_args()
    on_card = args.device != 'cpu'
    if on_card:
        from .timing import card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(card())
    if args.config is None:
        cfg, (h, w), draws = tiny_cascade_config(), (192, 256), 1
        shape, runs = (192., 250.), forms()
    else:
        cfg, (h, w), draws = args.config, FULL_HW, FULL_DRAW_SEED
        shape, runs = (float(h), float(w)), full_width_form(args.config)
    result = []
    for name, cpu, seed in runs:
        batch = bench.synthetic_batch(2, h, w, shape, torch.float32,
                                      seed=seed, device='cpu',
                                      masks=cpu.with_mask)
        f64 = _f64_step(cfg, cpu, batch, draws)
        f32 = _step(cpu, batch, draws)
        row = {'form': name, 'cpu_f32_vs_f64': _errors(f64, f32)}
        # the f64 step's proposals, without their gradient, fed to both
        props = f64[1]['proposals']
        f64_fixed = _f64_step(cfg, cpu, batch, draws, props)
        row['cpu_f32_vs_f64_same_proposals'] = _errors(
            f64_fixed, _step(cpu, batch, draws, props))
        if on_card:
            gpu = init_detector(cfg, device=args.device, train=True)
            gpu.load_state_dict(cpu.state_dict())
            card_f32 = _step(gpu, batch, draws)
            row['card_f32_vs_f64'] = _errors(f64, card_f32)
            row['card_vs_cpu_f32'] = _errors(f32, card_f32)
            row['card_f32_vs_f64_same_proposals'] = _errors(
                f64_fixed, _step(gpu, batch, draws, props))
            del gpu
        print(f'{name}: ' + '; '.join(
            f'{k} largest {v[0][0]:.3e} ({v[0][1]}), {TENSOR} {v[1]:.3e}, '
            f'losses {v[3]:.2e}, '
            'attention-map convs over 1e-3 (ReLU gates that differ, the '
            'largest |output| among them over the largest, the difference '
            'before and after adding their terms): ' + (', '.join(
                f'{t} {f["flips"]} {f["margin"]:.2e} {f["err"]:.3e} -> '
                f'{f["err_flips_added"]:.3e}' for t, f in v[2].items())
                or 'none') + '; candidates per stage (moved, assigned '
            'otherwise, their IoUs): ' + ', '.join(
                f'{c["moved"]} {c["reassigned"]} {c["ious"]}' for c in v[4])
            for k, v in row.items() if k != 'form'))
        result.append(row)
    print(json.dumps({'step_conditioning': result}))


if __name__ == '__main__':
    main()
