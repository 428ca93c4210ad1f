"""The port's SGD and LR schedule against the JAX package's optax chain:
three steps on the same gradients, with the flagship's schedule (linear
warmup from 0.02 * 0.001), weight decay, momentum and ``frozen_stages=1``."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn
from test_torch_arrff import FAST_COMPILE
from test_torch_threads import one_torch_thread  # noqa: F401

from arfe_tpu.train import build_lr_schedule as j_build_lr_schedule
from arfe_tpu.train import build_optimizer as j_build_optimizer
from arfe_tpu.train import frozen_prefixes_from_cfg as j_frozen_prefixes
from arfe_tpu_torch.train import (build_lr_schedule, build_optimizer,
                                  frozen_prefixes_from_cfg)

LR_CONFIG = dict(policy='step', warmup='linear', warmup_iters=500,
                 warmup_ratio=0.001, step=[8, 11])
SGD = dict(type='SGD', lr=0.02, momentum=0.9, weight_decay=0.0001)


class _Backbone(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 4, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(4)
        self.layer1 = nn.Linear(6, 5)
        self.layer2 = nn.Linear(5, 3)


class _Net(nn.Module):
    """Parameter names as the flagship's: a frozen stem and layer1, a
    BatchNorm whose running statistics are buffers."""

    def __init__(self):
        super().__init__()
        self.backbone = _Backbone()
        self.neck = nn.Linear(3, 2)


def _nested(flat):
    """{'a.b.c': x} -> {'a': {'b': {'c': x}}}."""
    out = {}
    for name, val in flat.items():
        *path, leaf = name.split('.')
        d = out
        for k in path:
            d = d.setdefault(k, {})
        d[leaf] = val
    return out


def _flat(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f'{prefix}{k}.'))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize('it', [0, 1, 2, 499, 500, 7999, 8000, 11000])
def test_lr_schedule_matches_jax(it):
    want = float(j_build_lr_schedule(LR_CONFIG, 0.02, 1000)(it))
    assert build_lr_schedule(LR_CONFIG, 0.02, 1000)(it) == pytest.approx(
        want, rel=1e-6)


@pytest.mark.parametrize('warmup', ['constant', 'exp', None])
def test_other_warmups_match_jax(warmup):
    cfg = dict(LR_CONFIG, warmup=warmup, warmup_ratio=0.1)
    sched, jsched = (f(cfg, 0.02, 100) for f in (build_lr_schedule,
                                                 j_build_lr_schedule))
    for it in (0, 3, 250, 499, 500, 900):
        assert sched(it) == pytest.approx(float(jsched(it)), rel=1e-6)


def test_frozen_prefixes_match_jax():
    for cfg in (dict(backbone=dict(frozen_stages=1)),
                dict(backbone=dict(frozen_stages=3)),
                dict(backbone=dict(frozen_stages=-1)),
                dict(backbone=dict(type='ResNetV1d', frozen_stages=2))):
        assert frozen_prefixes_from_cfg(cfg) == j_frozen_prefixes(cfg)


def test_sgd_three_steps_match_optax():
    """lr(0..2) of the warmup, decay added before the momentum trace, the
    trace starting as the gradient, nothing for the frozen parameters."""
    torch.manual_seed(0)
    net = _Net()
    with torch.no_grad():
        net.backbone.bn1.weight.uniform_(0.5, 1.5)
        net.backbone.bn1.running_mean.uniform_(-1, 1)
    frozen = frozen_prefixes_from_cfg(dict(backbone=dict(frozen_stages=1)))
    sched = build_lr_schedule(LR_CONFIG, 0.02, 1000)
    opt, scheduler = build_optimizer(SGD, sched, net, frozen)

    state = {k: v.detach().numpy().copy() for k, v in net.state_dict().items()
             if not k.endswith('num_batches_tracked')}
    jparams = jax.tree_util.tree_map(jnp.asarray, _nested(state))
    jopt = j_build_optimizer(SGD, j_build_lr_schedule(LR_CONFIG, 0.02, 1000),
                             jparams, j_frozen_prefixes(
                                 dict(backbone=dict(frozen_stages=1))))
    jstate = jopt.init(jparams)

    # the JAX step compiled once (op by op, each of its ops compiles)
    def jax_step(g, s, p):
        updates, s = jopt.update(g, s, p)
        return optax.apply_updates(p, updates), s
    jax_step = jax.jit(jax_step, compiler_options=FAST_COMPILE)

    rng = np.random.RandomState(1)
    start = {k: v.detach().clone() for k, v in net.named_parameters()}
    for it in range(3):
        assert opt.param_groups[0]['lr'] == pytest.approx(
            0.02 * (0.001 * (1 - it / 500) + it / 500), rel=1e-6)
        grads = {k: rng.randn(*v.shape).astype(np.float32)
                 for k, v in state.items()}
        opt.zero_grad()
        for name, p in net.named_parameters():
            p.grad = torch.from_numpy(grads[name])
        opt.step()
        scheduler.step()
        jparams, jstate = jax_step(
            jax.tree_util.tree_map(jnp.asarray, _nested(grads)), jstate,
            jparams)
        want = _flat(jparams)
        for name, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name],
                                       rtol=0, atol=1e-6)
        np.testing.assert_array_equal(
            net.backbone.bn1.running_mean.numpy(),
            want['backbone.bn1.running_mean'])
    for name, p in net.named_parameters():
        is_frozen = any(name.startswith(f) for f in frozen)
        assert torch.equal(p, start[name]) == is_frozen, name


def test_build_optimizer_refuses_what_is_not_ported():
    net = _Net()
    sched = build_lr_schedule(LR_CONFIG, 0.02, 1000)
    with pytest.raises(KeyError):
        build_optimizer(dict(type='Adam', lr=1e-3), sched, net)
    with pytest.raises(NotImplementedError):
        build_optimizer(dict(SGD, paramwise_cfg=dict(norm_decay_mult=0.)),
                        sched, net)
