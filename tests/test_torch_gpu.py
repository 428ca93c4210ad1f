"""The port's CUDA kernels against their plain versions on the card, their
gradients through the autograd Functions, and the tiny flagship's inference
and training step on the card against the CPU.

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


def _tiny_cfg(path=bench.FLAGSHIP_CFG):
    """The flagship (or another config of its family) at R18 and 64
    channels."""
    cfg = Config.fromfile(path)
    mc = cfg.model
    mc.backbone.depth = 18
    mc.neck[0].update(in_channels=[64, 128, 256, 512], out_channels=64)
    mc.neck[1].in_channels = 64
    mc.rpn_head.update(in_channels=64, feat_channels=64)
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
