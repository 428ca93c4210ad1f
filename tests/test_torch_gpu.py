"""The port's CUDA kernels against their plain versions on the card, their
gradients through the autograd Functions, the tiny flagship's inference
and training step on the card against the CPU (and those of Mask R-CNN,
Cascade R-CNN and RetinaNet), and the training run's loop and checkpoints
on the card.

Marked ``gpu``; every test skips where there is no CUDA device. This file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from arfe_tpu_torch.apis import init_detector
from arfe_tpu_torch.config import Config
from arfe_tpu_torch.core.bbox import bbox_overlaps
from arfe_tpu_torch.models.utils import get_adaptive_scale_rois
from arfe_tpu_torch.ops import fused_attention as fa
from arfe_tpu_torch.ops import roi_align as ra
from arfe_tpu_torch.tools.step_conditioning import (spread_classifiers,
                                                    tiny_cascade_config)
from arfe_tpu_torch.train import bench

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


# bf16: (1, 4200) the stride-16 level at 800x1344 with four key splits,
# (1, 4096) whole tiles, every split full, (1, 77) one ragged tile in the
# second split, (2, 130, 64) the tiny flagship's width
@pytest.mark.parametrize('b,n,c,dtype', [
    (1, 4200, 256, torch.float32), (2, 4200, 256, torch.bfloat16),
    (2, 77, 64, torch.float32), (3, 130, 128, torch.bfloat16),
    (1, 4200, 256, torch.bfloat16), (1, 4096, 256, torch.bfloat16),
    (1, 77, 256, torch.bfloat16), (2, 130, 64, torch.bfloat16)])
def test_attention_kernel_matches_plain(cuda, b, n, c, dtype):
    gen = torch.Generator(device=cuda).manual_seed(n + c)
    q, k, v = (torch.randn((b, n, c), generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    before = fa.launches
    got = fa.fused_softmax_attention(q, k, v)
    assert fa.launches == before + 1
    ref = fa.attention_plain(q, k, v)
    # f32: another summation order; bf16: each side rounds every
    # probability to bf16 once (csrc/fused_attention.cu derives the bound)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -8 * v.abs().max().item()
    assert got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert (got - ref).abs().max().item() <= tol


@pytest.mark.parametrize('n,c', [(77, 256), (128, 64)])
def test_attention_kernel_empty_split_adds_nothing(cuda, n, c):
    """Three key splits of two key tiles: the third has no key (m = -inf,
    l = 0) and the merge must skip it, not turn it into NaN."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    q, k, v = (torch.randn((1, n, c), generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    got = fa._launch(q, k, v, None, 3)   # a count key_splits never picks
    ref = fa.attention_plain(q, k, v)
    assert bool(torch.isfinite(got).all())
    assert (got - ref).abs().max().item() <= 2.0 ** -8 * v.abs().max().item()


# f32 (3xTF32 with the key split): (2, 4200) the bs2 training step's
# shape with two splits, (1, 77) three splits of one 32-key tile each,
# (3, 130, 128) and (1, 600, 128) ragged tiles at other widths
@pytest.mark.parametrize('b,n,c', [(2, 4200, 256), (1, 77, 256),
                                   (3, 130, 128), (1, 600, 128)])
def test_attention_f32_kernel_matches_plain(cuda, b, n, c):
    gen = torch.Generator(device=cuda).manual_seed(n + c + 1)
    q, k, v = (torch.randn((b, n, c), generator=gen, device=cuda)
               for _ in range(3))
    before = fa.launches
    got = fa.fused_softmax_attention(q, k, v)
    assert fa.launches == before + 1
    assert bool(torch.isfinite(got).all())
    assert (got - fa.attention_plain(q, k, v)).abs().max().item() <= 1e-4


@pytest.mark.parametrize('n,c,splits', [(77, 256, 4), (64, 64, 3)])
def test_attention_f32_kernel_empty_split_adds_nothing(cuda, n, c, splits):
    """f32 splits count 32-key tiles: N=77 has three, N=64 two, so the
    last of ``splits`` has no key and the merge must skip it."""
    gen = torch.Generator(device=cuda).manual_seed(n + 2)
    q, k, v = (torch.randn((1, n, c), generator=gen, device=cuda)
               for _ in range(3))
    got = fa._launch(q, k, v, None, splits)
    assert bool(torch.isfinite(got).all())
    assert (got - fa.attention_plain(q, k, v)).abs().max().item() <= 1e-4


def test_launch_counters_move_by_one_per_call(cuda):
    """One wrapper call is one launch on its counter, whatever it runs:
    kernel A split with its merge kernel, A unsplit, A in f32, kernel B."""
    q = torch.randn((1, 4200, 256), device=cuda).to(torch.bfloat16)
    one_tile = q[:, :64].contiguous()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert fa.key_splits(1, 4200, sms) > 1 and fa.key_splits(1, 64, sms) == 1
    for t in (q, one_tile, q.float()):
        before = fa.launches
        fa.fused_attention_cuda(t, t, t)
        assert fa.launches == before + 1
    feats = [torch.randn((1, 200 // s, 336 // s, 64), device=cuda)
             for s in (4, 8, 16, 32)]
    rois = _rois(torch.Generator(device=cuda).manual_seed(0), cuda, batch=1)
    for _ in range(2):
        before = ra.launches
        ra.roi_align_cuda(feats, rois, ra.map_roi_levels(rois, 4))
        assert ra.launches == before + 1


def test_attention_kernel_rejects_fp16(cuda):
    q = torch.zeros((1, 64, 64), dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        fa.fused_softmax_attention(q, q, q)


def _rois(gen, dev, num=400, batch=2, h=200.0, w=336.0):
    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(num, generator=gen, device=dev)
    x1, y1 = u(-20, w), u(-20, h)
    x2, y2 = x1 + torch.exp(u(-1, 5.5)), y1 + torch.exp(u(-1, 5.5))
    x1[:40], x2[:40] = x2[:40].clone(), x1[:40].clone()      # inverted
    x2[40:80], y2[40:80] = x1[40:80], y1[40:80]              # zero size
    x2[80:120] = w + 30                                      # past the border
    b = torch.randint(0, batch, (num,), generator=gen, device=dev).float()
    return torch.stack([b, x1, y1, x2, y2], 1).contiguous()


# R = 1000 with 256 channels: the bs1 serving count of proposals
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('channels,num', [(256, 400), (64, 400), (256, 1000)])
def test_roi_align_kernel_matches_plain(cuda, dtype, channels, num):
    gen = torch.Generator(device=cuda).manual_seed(channels)
    strides = (4, 8, 16, 32)
    feats = [torch.randn((2, 200 // s, 336 // s, channels), generator=gen,
                         device=cuda).to(dtype) for s in strides]
    rois = _rois(gen, cuda, num=num)
    lvls = ra.map_roi_levels(rois, 4)
    shift = torch.randint(-1, 2, lvls.shape, generator=gen, device=cuda)
    lvls = torch.clamp(lvls + shift.to(torch.int32), 0, 3).to(torch.int32)
    before = ra.launches
    got = ra.roi_align_pyramid(feats, rois, lvls, (7, 7), strides, 0)
    assert ra.launches == before + 1
    ref = ra.roi_align_pyramid_plain(feats, rois, lvls, (7, 7), strides, 2)
    assert got.dtype == dtype
    d = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert d.max().item() <= 1e-5
    else:   # the same f32 sums, rounded to bf16: at most one ulp apart
        assert bool((d <= 2.0 ** -7 * ref.float().abs() + 1e-6).all())


def test_roi_align_kernel_rejects_channels_off_the_vector(cuda):
    """The kernel reads 8 channels as one 16-byte vector: 12 channels
    raise, with no fallback."""
    feats = [torch.randn((1, 200 // s, 336 // s, 12), device=cuda)
             for s in (4, 8, 16, 32)]
    rois = _rois(torch.Generator(device=cuda).manual_seed(0), cuda, batch=1)
    before = ra.launches
    with pytest.raises(ValueError):
        ra.roi_align_cuda(feats, rois, ra.map_roi_levels(rois, 4))
    assert ra.launches == before


def test_roi_align_backward_kernel_rejects_channels_off_the_vector(cuda):
    """Kernel C adds 4 channels of a pixel as one 16-byte vector: 6
    channels raise, with no fallback."""
    rois = _rois(torch.Generator(device=cuda).manual_seed(0), cuda)
    g = torch.randn((rois.shape[0], 7, 7, 6), device=cuda)
    before = ra.bwd_launches
    with pytest.raises(ValueError):
        ra.roi_align_backward_cuda(g, rois, ra.map_roi_levels(rois, 4),
                                   _level_shapes(6))
    assert ra.bwd_launches == before


def _tiny_trunk_cfg(path):
    """A config's backbone, necks and RPN (where it has one) at R18 and 64
    channels."""
    cfg = Config.fromfile(path)
    mc = cfg.model
    mc.backbone.depth = 18
    mc.neck[0].update(in_channels=[64, 128, 256, 512], out_channels=64)
    mc.neck[1].in_channels = 64
    if 'rpn_head' in mc:
        mc.rpn_head.update(in_channels=64, feat_channels=64)
    return cfg


def _tiny_cfg(path=bench.FLAGSHIP_CFG):
    """The flagship (or another config of its family) at R18 and 64
    channels."""
    cfg = _tiny_trunk_cfg(path)
    mc = cfg.model
    mc.roi_head.bbox_roi_extractor.out_channels = 64
    mc.roi_head.bbox_head.update(in_channels=64, fc_out_channels=128)
    return cfg


def test_detector_on_card_matches_cpu(cuda):
    """The tiny flagship (R18, 64 channels) on the card, through both
    kernels, against the same weights on the CPU (plain versions)."""
    cfg = _tiny_cfg()
    cpu = init_detector(cfg, device='cpu')
    with torch.no_grad():
        cpu.neck[1].refine.conv_out.conv.weight.normal_(0, 0.02)
        cpu.roi_head.bbox_head.fc_cls.weight.mul_(30)
    gpu = init_detector(cfg, device='cuda')
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(0)
    img = torch.randn((1, 192, 256, 3), generator=gen) * 0.2
    shapes, scales = torch.tensor([[192., 250.]]), torch.ones(1, 4)
    with torch.no_grad():
        for fc, fg in zip(cpu.extract_feat(img),
                          gpu.extract_feat(img.to(cuda))):
            scale = fc.abs().max().item()
            assert (fg.cpu() - fc).abs().max().item() <= 1e-4 * scale
    want = cpu.simple_test(img, shapes, scales)
    a0, r0 = fa.launches, ra.launches
    got = [t.cpu() for t in gpu.simple_test(img.to(cuda), shapes.to(cuda),
                                            scales.to(cuda))]
    assert fa.launches == a0 + 1 and ra.launches == r0 + 1
    # every CPU detection has a card detection of its label with IoU > 0.7
    # and a score within 1e-2 (the rule of tests/test_e2e_parity_arfe.py)
    wd, wl = want[0][0][want[2][0]], want[1][0][want[2][0]]
    gd, gl = got[0][0][got[2][0]], got[1][0][got[2][0]]
    assert len(wd) >= 5 and len(gd) == len(wd)
    iou = bbox_overlaps(wd[:, :4], gd[:, :4])
    close = (iou > 0.7) & (wl[:, None] == gl[None]) \
        & ((wd[:, None, 4] - gd[None, :, 4]).abs() < 1e-2)
    assert bool(close.any(dim=1).all())


def _level_shapes(channels, b=2, h=200, w=336, strides=(4, 8, 16, 32)):
    return [(b, h // s, w // s, channels) for s in strides]


def _shifted_levels(gen, rois, dev):
    lvls = ra.map_roi_levels(rois, 4)
    shift = torch.randint(-1, 2, lvls.shape, generator=gen, device=dev)
    return torch.clamp(lvls + shift.to(torch.int32), 0, 3).to(torch.int32)


@pytest.mark.parametrize('channels', [256, 64])
def test_roi_align_backward_kernel_matches_plain(cuda, channels):
    """Kernel C against ``roi_align_backward_plain``. The f32 atomics add in
    another order from run to run: each pixel within 1e-5 of the sum of its
    terms' magnitudes (the plain backward of |g|), plus 1e-7."""
    gen = torch.Generator(device=cuda).manual_seed(channels + 1)
    rois = _rois(gen, cuda)
    lvls = _shifted_levels(gen, rois, cuda)
    shapes = _level_shapes(channels)
    g = torch.randn((rois.shape[0], 7, 7, channels), generator=gen,
                    device=cuda)
    before = ra.bwd_launches
    got = ra.roi_align_backward_cuda(g, rois, lvls, shapes)
    assert ra.bwd_launches == before + 1
    want = ra.roi_align_backward_plain(g, rois, lvls, shapes)
    scale = ra.roi_align_backward_plain(g.abs(), rois, lvls, shapes)
    for d, w, s in zip(got, want, scale):
        assert d.dtype == torch.float32 and d.shape == w.shape
        assert bool(((d - w).abs() <= 1e-5 * s + 1e-7).all())
    assert any(bool(w.any()) for w in want)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_roi_align_gradient_on_card(cuda, dtype):
    """``torch.autograd.grad`` through ``roi_align_pyramid``: kernels B and
    C. f32: the plain forward's autograd, to the kernel's tolerance; bf16:
    the plain backward rounded to bf16, at most one bf16 ulp apart."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    strides = (4, 8, 16, 32)
    feats = [torch.randn(s, generator=gen, device=cuda).to(dtype)
             .requires_grad_() for s in _level_shapes(64)]
    rois = _rois(gen, cuda)
    lvls = _shifted_levels(gen, rois, cuda)
    g = torch.randn((rois.shape[0], 7, 7, 64), generator=gen, device=cuda)
    b0, c0 = ra.launches, ra.bwd_launches
    out = ra.roi_align_pyramid(feats, rois, lvls, (7, 7), strides, 0)
    got = torch.autograd.grad(out, feats, g.to(dtype))
    assert (ra.launches, ra.bwd_launches) == (b0 + 1, c0 + 1)
    shapes = [f.shape for f in feats]
    scale = ra.roi_align_backward_plain(g.abs(), rois, lvls, shapes)
    if dtype == torch.float32:
        ref = ra.roi_align_pyramid_plain(feats, rois, lvls, (7, 7), strides)
        want = torch.autograd.grad(ref, feats, g)
    else:
        want = [w.to(dtype) for w in ra.roi_align_backward_plain(
            g.to(dtype), rois, lvls, shapes)]
    for d, w, s in zip(got, want, scale):
        assert d.dtype == dtype
        allowed = 1e-5 * s + 1e-7
        if dtype == torch.bfloat16:
            allowed = allowed + 2.0 ** -7 * w.float().abs()
        assert bool(((d.float() - w.float()).abs() <= allowed).all())


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_attention_gradient_on_card(cuda, dtype):
    """The forward is kernel A, the backward the VJP of ``attention_plain``:
    the gradients are those of the plain version's autograd."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (torch.randn((2, 600, 128), generator=gen, device=cuda)
               .to(dtype).requires_grad_() for _ in range(3))
    g = torch.randn((2, 600, 128), generator=gen, device=cuda)
    before = fa.launches
    got = torch.autograd.grad(fa.fused_softmax_attention(q, k, v),
                              (q, k, v), g)
    assert fa.launches == before + 1
    want = torch.autograd.grad(fa.attention_plain(q, k, v), (q, k, v), g)
    for d, w in zip(got, want):
        assert d.dtype == dtype and bool(torch.isfinite(d).all())
        tol = 1e-6 * w.float().abs().max().item()
        assert (d.float() - w.float()).abs().max().item() <= tol


def _stretched_rois(gen, dev, num=500, batch=2, h=200.0, w=336.0):
    """Proposal-like boxes inside a (h, w) image, then their AR-RFF
    stretches (``get_adaptive_scale_rois``) after them as the RoI head
    extracts them, [ori, lw, lh]: thin boxes stretch far past the bottom or
    the right edge."""
    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(num, generator=gen, device=dev)
    x1, y1 = u(0, w - 2), u(0, h - 2)
    x2 = torch.minimum(x1 + torch.exp(u(0, 5.5)), torch.tensor(w))
    y2 = torch.minimum(y1 + torch.exp(u(0, 5.5)), torch.tensor(h))
    b = torch.randint(0, batch, (num,), generator=gen, device=dev).float()
    rois = torch.stack([b, x1, y1, x2, y2], 1)
    lh, lw = get_adaptive_scale_rois(rois, 1.0)
    rois = torch.cat([rois, lw, lh]).contiguous()
    assert bool((rois[:, 3] > w).any()) and bool((rois[:, 4] > h).any())
    return rois


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_roi_align_kernel_on_stretched_rois(cuda, dtype):
    """Kernel B on AR-RFF's triple RoIs, each on the level of its own box:
    samples past the level's edge read as zero, as in the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    strides = (4, 8, 16, 32)
    feats = [torch.randn((2, 200 // s, 336 // s, 256), generator=gen,
                         device=cuda).to(dtype) for s in strides]
    rois = _stretched_rois(gen, cuda)
    lvls = ra.map_roi_levels(rois, 4)
    got = ra.roi_align_cuda(feats, rois, lvls, (7, 7), strides, 2, True)
    ref = ra.roi_align_pyramid_plain(feats, rois, lvls, (7, 7), strides, 2)
    d = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert d.max().item() <= 1e-5
    else:
        assert bool((d <= 2.0 ** -7 * ref.float().abs() + 1e-6).all())


def test_roi_align_backward_kernel_on_stretched_rois(cuda):
    """Kernel C on AR-RFF's triple RoIs, each on the level of its own box,
    within 1e-5 of the sum of its terms' magnitudes, plus 1e-7."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    rois = _stretched_rois(gen, cuda)
    lvls = ra.map_roi_levels(rois, 4)
    shapes = _level_shapes(256)
    g = torch.randn((rois.shape[0], 7, 7, 256), generator=gen, device=cuda)
    got = ra.roi_align_backward_cuda(g, rois, lvls, shapes)
    want = ra.roi_align_backward_plain(g, rois, lvls, shapes)
    scale = ra.roi_align_backward_plain(g.abs(), rois, lvls, shapes)
    for d, w, s in zip(got, want, scale):
        assert bool(((d - w).abs() <= 1e-5 * s + 1e-7).all())


@pytest.mark.parametrize('name', ['arrff', 'fac'])
def test_arfe_train_step_on_card_matches_cpu(cuda, name):
    """One f32 step of the tiny AR-RFF (one launch of kernel B and one of C
    over the triple RoIs) and "+fac" detectors on the card against the
    CPU, under the tolerances of ``test_train_step_on_card_matches_cpu``."""
    cfg = _tiny_cfg(bench.ARFE_CFGS[name])
    torch.manual_seed(0)
    cpu = init_detector(cfg, device='cpu', train=True)
    with torch.no_grad():
        cpu.neck[1].refine.conv_out.conv.weight.normal_(0, 0.02)
    gpu = init_detector(cfg, device=cuda, train=True)
    gpu.load_state_dict(cpu.state_dict())
    batch = bench.synthetic_batch(2, 192, 256, (192.0, 250.0),
                                  torch.float32, seed=3, device='cpu')
    counts = (fa.launches, ra.launches, ra.bwd_launches)
    r = bench.compare_with_cpu(gpu, cpu, batch, seed=1)
    assert [n - c for n, c in zip(
        (fa.launches, ra.launches, ra.bwd_launches), counts)] == [1, 1, 1]
    assert r['ok'], r


def test_train_step_on_card_matches_cpu(cuda):
    """One f32 forward_train + backward of the tiny flagship on the card
    (kernels A, B and C) and on the CPU, with the same weights and sampling
    priorities, under ``bench.compare_with_cpu``'s tolerances: each loss
    within 1e-4 + 4x the CPU's own relative spread (one thread against
    all), each parameter's largest gradient difference within 5e-2 of its
    largest |g| (rounding alone moves some by ~1e-2 at random weights; a
    wrong kernel differs by O(1)). The weights are seeded: at some random
    weights an AR-FPN attention-map conv, whose gradient passes through a
    few unsaturated tanh outputs, differs by more than that between two
    summation orders, whatever the kernels."""
    cfg = _tiny_cfg()
    torch.manual_seed(0)
    cpu = init_detector(cfg, device='cpu', train=True)
    with torch.no_grad():
        cpu.neck[1].refine.conv_out.conv.weight.normal_(0, 0.02)
    gpu = init_detector(cfg, device=cuda, train=True)
    gpu.load_state_dict(cpu.state_dict())
    rng = torch.Generator().manual_seed(0)
    b, h, w, num_gts = 2, 192, 256, 8
    xy = torch.rand((b, num_gts, 2), generator=rng) * torch.tensor(
        [w - 70.0, h - 70.0])
    gt = torch.cat([xy, xy + 20 + 50 * torch.rand((b, num_gts, 2),
                                                  generator=rng)], -1)
    valid = torch.arange(num_gts)[None].expand(b, -1) < torch.tensor([[6],
                                                                       [4]])
    batch = dict(img=torch.randn((b, h, w, 3), generator=rng) * 0.2,
                 img_shape=torch.tensor([[192.0, 250.0], [180.0, 256.0]]),
                 gt_bboxes=gt, gt_valid=valid,
                 gt_labels=torch.randint(0, 80, (b, num_gts), generator=rng))
    counts = (fa.launches, ra.launches, ra.bwd_launches)
    r = bench.compare_with_cpu(gpu, cpu, batch, seed=1)
    assert [n - c for n, c in zip(
        (fa.launches, ra.launches, ra.bwd_launches), counts)] == [1, 1, 1]
    assert r['ok'], r


def test_train_detector_launches_each_kernel_once_per_iteration(cuda,
                                                                tmp_path):
    """bf16 iterations of ``train_detector`` (the e2e smoke's tiny AR-FPN +
    AR-RFF config, one epoch of 4 iterations): kernels A, B and C launch
    once per iteration; the losses are finite."""
    from arfe_tpu_torch.apis import train_detector
    from arfe_tpu_torch.data import build_dataset
    from arfe_tpu_torch.layers import init_weights
    from arfe_tpu_torch.models import build_detector
    from arfe_tpu_torch.tools import e2e_smoke
    cfg = Config.fromfile(e2e_smoke.write_set(str(tmp_path), 1))
    cfg.work_dir = str(tmp_path / 'work')
    d = cfg.todict()
    model = build_detector(d['model'], train_cfg=d['train_cfg'],
                           test_cfg=d['test_cfg'])
    init_weights(model, torch.Generator().manual_seed(0))
    counts = (fa.launches, ra.launches, ra.bwd_launches)
    history = train_detector(model, build_dataset(d['data']['train']), cfg,
                             device=cuda, dtype=torch.bfloat16)
    assert len(history) == 4
    assert all(torch.isfinite(torch.tensor(e['loss'])) for e in history)
    assert [n - c for n, c in zip(
        (fa.launches, ra.launches, ra.bwd_launches), counts)] == [4, 4, 4]


def test_checkpoint_moves_between_card_and_cpu(cuda, tmp_path):
    """A ``.pth`` saved from the card (weights, SGD momentum, scheduler)
    loads on the CPU, and one saved from the CPU loads on the card, equal."""
    from arfe_tpu_torch.train import build_lr_schedule, build_optimizer
    from arfe_tpu_torch.utils import load_checkpoint, save_checkpoint
    cfg = _tiny_cfg()
    for src, dst in ((cuda, 'cpu'), ('cpu', cuda)):
        model = init_detector(cfg, device=src)
        opt, sched = build_optimizer(
            dict(type='SGD', lr=0.02, momentum=0.9), build_lr_schedule(
                dict(policy='step', step=[1]), 0.02, 10), model)
        for p in model.parameters():
            p.grad = torch.ones_like(p)
        opt.step()
        sched.step()
        path = save_checkpoint(str(tmp_path / f'{src}.pth'), model, opt,
                               sched, dict(epoch=1))
        other = init_detector(cfg, path, device=dst)
        for k, v in model.state_dict().items():
            assert torch.equal(other.state_dict()[k].cpu(), v.cpu()), k
        opt2, sched2 = build_optimizer(
            dict(type='SGD', lr=0.02, momentum=0.9), build_lr_schedule(
                dict(policy='step', step=[1]), 0.02, 10), other)
        _, meta, opt_state, sched_state = load_checkpoint(path)
        opt2.load_state_dict(opt_state)
        sched2.load_state_dict(sched_state)
        assert meta['epoch'] == 1 and sched2.last_epoch == 1
        for p, q in zip(opt.param_groups[0]['params'],
                        opt2.param_groups[0]['params']):
            buf = opt2.state[q]['momentum_buffer']
            assert buf.device == q.device
            assert torch.equal(buf.cpu(), opt.state[p][
                'momentum_buffer'].cpu())


def _mask_rois(gen, dev, num=200, batch=2, h=200.0, w=336.0):
    """Detection-like boxes of 2-200 px and, as ``simple_test_mask`` extracts
    the empty detection slots, a quarter of them the padding's [0, 0, 0,
    0]."""
    rois = _rois(gen, dev, num=num, batch=batch, h=h, w=w)
    rois[num - num // 4:, 1:] = 0.0
    return rois


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('channels', [256, 64])
def test_roi_align_kernel_at_14x14_matches_plain(cuda, dtype, channels):
    """Kernel B at the mask extractor's 14 x 14 bins: bit for bit the plain
    version's in f32 (products and sums rounded one by one) and in bf16
    (the same f32 sums, rounded once), padding slots included."""
    gen = torch.Generator(device=cuda).manual_seed(14 + channels)
    strides = (4, 8, 16, 32)
    feats = [torch.randn((2, 200 // s, 336 // s, channels), generator=gen,
                         device=cuda).to(dtype) for s in strides]
    rois = _mask_rois(gen, cuda)
    lvls = _shifted_levels(gen, rois, cuda)
    before = ra.launches
    got = ra.roi_align_pyramid(feats, rois, lvls, (14, 14), strides, 0)
    assert ra.launches == before + 1
    ref = ra.roi_align_pyramid_plain(feats, rois, lvls, (14, 14), strides, 2)
    assert got.shape == (200, 14, 14, channels) and got.dtype == dtype
    assert torch.equal(got, ref)


@pytest.mark.parametrize('channels', [256, 64])
def test_roi_align_backward_kernel_at_14x14_matches_plain(cuda, channels):
    """Kernel C at 14 x 14 bins (a RoI's footprint up to 56 x 56 pixels, 112
    corner candidates per axis pair), padding slots included: within 1e-5
    of the sum of its terms' magnitudes, plus 1e-7."""
    gen = torch.Generator(device=cuda).manual_seed(15 + channels)
    rois = _mask_rois(gen, cuda)
    lvls = _shifted_levels(gen, rois, cuda)
    shapes = _level_shapes(channels)
    g = torch.randn((rois.shape[0], 14, 14, channels), generator=gen,
                    device=cuda)
    before = ra.bwd_launches
    got = ra.roi_align_backward_cuda(g, rois, lvls, shapes, (14, 14))
    assert ra.bwd_launches == before + 1
    want = ra.roi_align_backward_plain(g, rois, lvls, shapes, (14, 14))
    scale = ra.roi_align_backward_plain(g.abs(), rois, lvls, shapes,
                                        (14, 14))
    for d, w, s in zip(got, want, scale):
        assert bool(((d - w).abs() <= 1e-5 * s + 1e-7).all())
    assert any(bool(w.any()) for w in want)


def _tiny_mask_cfg():
    cfg = _tiny_cfg(bench.MASK_CFG)
    cfg.model.roi_head.mask_roi_extractor.out_channels = 64
    cfg.model.roi_head.mask_head.update(in_channels=64, conv_out_channels=64)
    return cfg


def test_mask_rcnn_on_card_matches_cpu(cuda):
    """The tiny Mask R-CNN on the card: one launch of A and two of B (7 x 7
    and 14 x 14) per request; detections and the matched detections' mask
    logits against the CPU; one f32 step (A once, B and C twice) against
    the CPU's losses and gradients, ``mask_head.*`` included."""
    cfg = _tiny_mask_cfg()
    cpu = init_detector(cfg, device='cpu', train=True)
    with torch.no_grad():
        cpu.neck[1].refine.conv_out.conv.weight.normal_(0, 0.02)
        cpu.roi_head.bbox_head.fc_cls.weight.mul_(30)
    gpu = init_detector(cfg, device='cuda', train=True)
    gpu.load_state_dict(cpu.state_dict())
    img = torch.randn((1, 192, 256, 3),
                      generator=torch.Generator().manual_seed(0)) * 0.2
    shapes, scales = torch.tensor([[192., 250.]]), torch.ones(1, 4)
    want = cpu.simple_test(img, shapes, scales)
    a0, r0 = fa.launches, ra.launches
    got = [t.cpu() for t in gpu.simple_test(img.to(cuda), shapes.to(cuda),
                                            scales.to(cuda))]
    assert fa.launches == a0 + 1 and ra.launches == r0 + 2
    wv, gv = want[2][0], got[2][0]
    wd, gd = want[0][0][wv], got[0][0][gv]
    assert len(wd) >= 5 and len(gd) == len(wd)
    close = (bbox_overlaps(wd[:, :4], gd[:, :4]) > 0.7) \
        & (want[1][0][wv][:, None] == got[1][0][gv][None]) \
        & ((wd[:, None, 4] - gd[None, :, 4]).abs() < 1e-2)
    assert bool(close.any(dim=1).all())
    wm, gm = want[3][0][wv], got[3][0][gv]
    j = close.float().argmax(dim=1)
    assert (gm[j] - wm).abs().max().item() <= 1e-3 * max(
        1.0, wm.abs().max().item())
    batch = bench.synthetic_batch(2, 192, 256, (192., 250.), torch.float32,
                                  seed=3, device='cpu', masks=True)
    cpu.train()
    gpu.train()
    a0, r0, c0 = fa.launches, ra.launches, ra.bwd_launches
    r = bench.compare_with_cpu(gpu, cpu, batch)
    assert 'loss_mask' in r['loss_err']
    assert (fa.launches - a0, ra.launches - r0, ra.bwd_launches - c0) \
        == (1, 2, 2)
    assert r['ok'], r
    assert any(k.startswith('roi_head.mask_head.') for k in r['cpu'][1])


# RetinaNet's refine level at 800x1344: N = 25 x 42 = 1050 tokens (stride
# 32 of five levels from stride 8), ragged in the query and the key tiles
# (bf16: 16 x 64 + 26; f32: 8 x 128 + 26 query rows, 32 x 32 + 26 keys)
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b', [1, 2])
def test_attention_kernel_at_retinanet_refine_level(cuda, b, dtype):
    """Kernel A at N = 1050 with the split count ``key_splits`` picks, and
    with a forced count that leaves splits without keys, against the plain
    version."""
    n = 1050
    gen = torch.Generator(device=cuda).manual_seed(n + b)
    q, k, v = (torch.randn((b, n, 256), generator=gen, device=cuda)
               .to(dtype) for _ in range(3))
    ref = fa.attention_plain(q, k, v)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -8 * v.abs().max().item()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    key_tiles = -(-n // fa.TILES[dtype][1])
    picked = fa.key_splits(b, n, sms, dtype)
    assert 1 <= picked <= min(key_tiles, fa.MOST_SPLITS)
    forced = next(s for s in range(2, fa.MOST_SPLITS + 1)
                  if -(-key_tiles // -(-key_tiles // s)) < s)
    before = fa.launches
    for got in (fa.fused_softmax_attention(q, k, v),
                fa._launch(q, k, v, None, forced)):
        assert bool(torch.isfinite(got).all())
        assert (got - ref).abs().max().item() <= tol
    assert fa.launches == before + 2


def _detections_match(want, got, margin=1e-3):
    """Every detection of either side scoring ``margin`` above the higher of
    the two sides' lowest scores (the score threshold or the 100-detection
    cut, where f32 rounding decides) has a detection of its label on the
    other side with IoU > 0.7 and a score within 1e-2 (the rule of
    tests/test_e2e_parity_arfe.py); at least 5 do."""
    dets = [(d[0][0][d[2][0]], d[1][0][d[2][0]]) for d in (want, got)]
    floor = max(float(d[:, 4].min()) for d, _ in dets) + margin
    for (ad, al), (bd, bl) in (dets, dets[::-1]):
        keep = ad[:, 4] >= floor
        ad, al = ad[keep], al[keep]
        assert len(ad) >= 5
        close = (bbox_overlaps(ad[:, :4], bd[:, :4]) > 0.7) \
            & (al[:, None] == bl[None]) \
            & ((ad[:, None, 4] - bd[None, :, 4]).abs() < 1e-2)
        assert bool(close.any(dim=1).all())


def test_cascade_rcnn_on_card_matches_cpu(cuda):
    """The tiny Cascade R-CNN on the card: one launch of A and three of B
    (a stage each) per request, each stage's B bit for bit its plain
    version on that stage's RoIs; detections against the CPU (classifiers
    spread); one f32 step of the seeded weights, as
    ``test_arfe_train_step_on_card_matches_cpu`` takes it (A once, B and C
    three times), against the CPU's losses and gradients, each stage's C
    within 1e-5 of its plain version on that stage's cotangent."""
    cfg = tiny_cascade_config()
    cpu = init_detector(cfg, device='cpu', train=True)
    img = torch.randn((1, 192, 256, 3),
                      generator=torch.Generator().manual_seed(0)) * 0.2
    shapes, scales = torch.tensor([[192., 250.]]), torch.ones(1, 4)
    want = spread_classifiers(
        cpu, [h.fc_cls.weight for h in cpu.roi_head.bbox_head], img)
    gpu = init_detector(cfg, device='cuda', train=True)
    gpu.load_state_dict(cpu.state_dict())
    torch.manual_seed(0)
    cpu_step = init_detector(cfg, device='cpu', train=True)
    with torch.no_grad():
        cpu_step.neck[1].refine.conv_out.conv.weight.normal_(0, 0.02)
    gpu_step = init_detector(cfg, device='cuda', train=True)
    gpu_step.load_state_dict(cpu_step.state_dict())
    kernel_b, kernel_c, args_b, args_c = (ra.roi_align_cuda,
                                          ra.roi_align_backward_cuda, [], [])

    def keep_b(feats, rois, lvls, *rest, **kwargs):
        args_b.append((feats, rois.clone(), lvls.clone()))
        return kernel_b(feats, rois, lvls, *rest, **kwargs)

    def keep_c(g, rois, lvls, shapes, *rest, **kwargs):
        args_c.append((g.clone(), rois.clone(), lvls.clone(),
                       [tuple(s) for s in shapes]))
        return kernel_c(g, rois, lvls, shapes, *rest, **kwargs)
    ra.roi_align_cuda, ra.roi_align_backward_cuda = keep_b, keep_c
    try:
        a0, r0 = fa.launches, ra.launches
        got = [t.cpu() for t in gpu.simple_test(
            img.to(cuda), shapes.to(cuda), scales.to(cuda))]
        assert (fa.launches - a0, ra.launches - r0) == (1, 3)
        _detections_match(want, got)
        strides = (4, 8, 16, 32)
        for feats, rois, lvls in args_b:
            assert torch.equal(
                kernel_b(feats, rois, lvls, (7, 7), strides, 2, True),
                ra.roi_align_pyramid_plain(feats, rois, lvls, (7, 7),
                                           strides, 2, True))
        batch = bench.synthetic_batch(2, 192, 256, (192., 250.),
                                      torch.float32, seed=3, device='cpu')
        args_c.clear()
        counts = (fa.launches, ra.launches, ra.bwd_launches)
        r = bench.compare_with_cpu(gpu_step, cpu_step, batch, seed=1)
        assert [n - c for n, c in zip(
            (fa.launches, ra.launches, ra.bwd_launches), counts)] \
            == [1, 3, 3]
    finally:
        ra.roi_align_cuda, ra.roi_align_backward_cuda = kernel_b, kernel_c
    assert r['ok'], (r['loss_err'], r['grad_err'], r['grad_spread'])
    assert sorted(r['loss_err']) == sorted(
        ['loss', 'loss_rpn_cls', 'loss_rpn_bbox'] + [
            f's{i}.{k}' for i in range(3)
            for k in ('loss_cls', 'acc', 'loss_bbox')])
    assert len(args_c) == 3
    for g, rois, lvls, level_shapes in args_c:
        got = kernel_c(g, rois, lvls, level_shapes, (7, 7))
        want = ra.roi_align_backward_plain(g, rois, lvls, level_shapes,
                                           (7, 7))
        scale = ra.roi_align_backward_plain(g.abs(), rois, lvls,
                                            level_shapes, (7, 7))
        for d, w, s in zip(got, want, scale):
            assert bool(((d - w).abs() <= 1e-5 * s + 1e-7).all())


def test_retinanet_on_card_matches_cpu(cuda):
    """The tiny RetinaNet on the card: one launch of A and none of B per
    request, detections against the CPU; one f32 step (A once, no B or C)
    against the CPU's losses and gradients."""
    cfg = _tiny_trunk_cfg(bench.RETINA_CFG)
    cfg.model.bbox_head.update(in_channels=64, feat_channels=64,
                               stacked_convs=2)
    cpu = init_detector(cfg, device='cpu', train=True)
    img = torch.randn((1, 192, 256, 3),
                      generator=torch.Generator().manual_seed(0)) * 0.2
    shapes, scales = torch.tensor([[192., 250.]]), torch.ones(1, 4)
    want = spread_classifiers(cpu, [cpu.bbox_head.retina_cls.weight],
                              img)
    gpu = init_detector(cfg, device='cuda', train=True)
    gpu.load_state_dict(cpu.state_dict())
    a0, r0 = fa.launches, ra.launches
    got = [t.cpu() for t in gpu.simple_test(img.to(cuda), shapes.to(cuda),
                                            scales.to(cuda))]
    assert (fa.launches - a0, ra.launches - r0) == (1, 0)
    _detections_match(want, got)
    batch = bench.synthetic_batch(2, 192, 256, (192., 250.), torch.float32,
                                  seed=3, device='cpu')
    counts = (fa.launches, ra.launches, ra.bwd_launches)
    r = bench.compare_with_cpu(gpu, cpu, batch)
    assert [n - c for n, c in zip(
        (fa.launches, ra.launches, ra.bwd_launches), counts)] == [1, 0, 0]
    assert r['ok'], r
    assert sorted(r['loss_err']) == ['loss', 'loss_bbox', 'loss_cls']
