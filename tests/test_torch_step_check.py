"""The card-against-CPU step check of ``arfe_tpu_torch/train/bench.py`` on
the CPU, with a second CPU instance in the card's place: the tiny Mask
R-CNN C4 (``tests/test_c4_models.py:19-31``'s cut), whose RPN chooses from
one level. The check recovers the CPU's choice of proposals by value, feeds
it to the other runs with their own gradient, and holds the other run's own
choice against the plain selection from its candidates, which must find a
wrong selection.
"""
import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401

from arfe_tpu_torch.apis import init_detector
from arfe_tpu_torch.config import Config
from arfe_tpu_torch.train import bench


@pytest.fixture(scope='module')
def models():
    cfg = Config.fromfile(bench.C4_MASK_CFG)
    mc = cfg.model
    mc.backbone.base_channels = 8
    mc.rpn_head.update(in_channels=128, feat_channels=128)
    mc.roi_head.bbox_roi_extractor.out_channels = 128
    mc.roi_head.shared_head.base_channels = 8
    mc.roi_head.bbox_head.in_channels = 256
    mc.roi_head.mask_head.in_channels = 256
    cfg.train_cfg.rpn_proposal.update(nms_pre=400, nms_post=128, max_num=128)
    cfg.train_cfg.rcnn.sampler.num = 64
    torch.manual_seed(0)
    cpu = init_detector(cfg, device='cpu', train=True)
    other = init_detector(cfg, device='cpu', train=True)
    other.load_state_dict(cpu.state_dict())
    batch = bench.synthetic_batch(2, 192, 256, (192., 250.), torch.float32,
                                  seed=3, device='cpu', masks=True)
    return cpu, other, batch


def test_step_check_passes_the_same_model(models):
    """Two instances with the same weights: every loss and gradient the
    same, no proposal chosen otherwise, the selection the same."""
    cpu, other, batch = models
    r = bench.compare_with_cpu(other, cpu, batch)
    assert r['ok'], r
    assert r['selection_faults'] == 0 and r['other_proposals'] == [0, 0]
    assert r['grad_err'][0] == 0 and not any(r['loss_err'].values())


def test_chosen_candidates_give_the_own_step(models):
    """The proposals recovered by value and decoded again from the same
    model (``chosen``) give its own losses and gradients, the gradient
    through the decoded proposals into ``rpn_reg`` included."""
    cpu, _, batch = models
    seen = []
    own = bench.loss_and_grads(cpu, batch, rpn_seen=seen)
    chosen = bench.chosen_candidates(cpu.rpn_head, seen[0])
    assert int((chosen >= 0).sum()) == int(seen[0][4].sum()) > 0
    fed = bench.loss_and_grads(cpu, batch, chosen=chosen)
    losses, (grad, _) = bench.differences(own, fed)
    assert not any(losses.values()) and grad == 0
    assert fed[1]['rpn_head.rpn_reg.weight'].abs().max() > 0


@pytest.mark.parametrize('fault', ['nms_thr', 'duplicate'])
def test_selection_faults_finds_a_wrong_selection(models, fault):
    """A choice made at another NMS threshold, or one slot holding another
    slot's proposal, differs from the plain selection from the same
    candidates; the right choice does not."""
    cpu, other, batch = models
    seen = []
    bench.loss_and_grads(other, batch, rpn_seen=seen)
    shared, shapes, cfg, dets, valid = seen[0]
    assert bench.selection_faults(other.rpn_head, cpu.rpn_head, seen[0]) == 0
    if fault == 'nms_thr':
        dets, valid = other.rpn_head.get_proposals(
            None, shapes, dict(cfg, nms_thr=cfg['nms_thr'] - 0.01), shared)
    else:
        dets = dets.clone()
        dets[0, 5] = dets[0, 6]
    assert bench.selection_faults(other.rpn_head, cpu.rpn_head,
                                  (shared, shapes, cfg, dets, valid)) > 0
