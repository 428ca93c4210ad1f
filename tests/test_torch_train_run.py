"""The training run of the port on the CPU against the JAX package: the
train pipeline, the loader's sampler and collate, the gradient clip, then
``train_detector``'s loop against the JAX package's ``build_optimizer`` +
``make_train_step`` over the JAX loader's batches, resume, the JAX package
reading the port's checkpoint, and the CLIs.

The loop runs the JAX tool's tiny config (``tools/e2e_smoke.py``: R18, a
64-channel FPN, ``Shared2FCBBoxHead``, one class) on 4 PNGs of 128x160 with
flips off, 2 epochs of 2 iterations, its LR stepped after the first epoch
and its gradient clipped at 5. Both sides start from the port's seeded
weights (through ``state_dict_to_params``) and share numpy-drawn sampling
priorities, as ``test_torch_train.py`` does; the JAX instance's RoIs get no
gradient. ``tools.e2e_smoke`` runs the AR-FPN neck and the AR-RFF head.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_optimizer import LR_CONFIG, SGD, _flat, _Net, _nested
from test_torch_train import _patch_jax, _patch_torch, stop_roi_gradient
from test_torch_threads import one_torch_thread  # noqa: F401

from arfe_tpu import Config as JConfig
from arfe_tpu.apis.inference import init_detector as j_init_detector
from arfe_tpu.convert import state_dict_to_params
from arfe_tpu.data import build_dataloader as j_build_dataloader
from arfe_tpu.data import build_dataset as j_build_dataset
from arfe_tpu.data.builder import GroupBatchSampler as JGroupBatchSampler
from arfe_tpu.data.builder import collate_detection
from arfe_tpu.models import build_detector as j_build_detector
from arfe_tpu.train import build_lr_schedule as j_build_lr_schedule
from arfe_tpu.train import build_optimizer as j_build_optimizer
from arfe_tpu.train import frozen_prefixes_from_cfg as j_frozen_prefixes
from arfe_tpu.train import make_train_step as j_make_train_step
from arfe_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from arfe_tpu.utils.pretrained import \
    load_pretrained_backbone as j_load_pretrained_backbone
from arfe_tpu_torch.apis import init_detector, train_detector
from arfe_tpu_torch.config import Config
from arfe_tpu_torch.convert import params_to_state_dict
from arfe_tpu_torch.data import (GroupBatchSampler, build_dataset,
                                 collate_train, synthetic)
from arfe_tpu_torch.layers import init_weights
from arfe_tpu_torch.models import build_detector
from arfe_tpu_torch.tools import e2e_smoke
from arfe_tpu_torch.tools import train as train_cli
from arfe_tpu_torch.train import (build_grad_clip, build_lr_schedule,
                                  build_optimizer, frozen_prefixes_from_cfg)
from arfe_tpu_torch.train.bench import num_anchors
from arfe_tpu_torch.utils import load_pretrained_backbone, save_checkpoint

BOX = [dict(id=1, name='box')]
# XLA compiles the tiny detector's programs faster at its lowest
# optimisation level (as test_torch_arrff.py does)
FAST_COMPILE = {'xla_backend_optimization_level': 0,
                'xla_llvm_disable_expensive_passes': True}
JAX_BATCH_KEYS = ('img', 'img_shape', 'gt_bboxes', 'gt_valid', 'gt_labels')


# --------------------------------------------------------------------------
# the pieces: pipeline, sampler, collate, gradient clip
# --------------------------------------------------------------------------

def _coco_train_cfg(root, flip_ratio):
    """``coco_detection.py``'s ``data.train`` on a box set, with its flip
    forced off or on."""
    cfg = Config.fromfile(os.path.join(
        os.path.dirname(__file__), '..', 'configs', '_base_', 'datasets',
        'coco_detection.py')).todict()['data']['train']
    cfg.update(ann_file=f'{root}/ann.json', img_prefix=f'{root}/imgs/')
    cfg['pipeline'][3]['flip_ratio'] = flip_ratio
    return cfg


@pytest.fixture(scope='module')
def box_set(tmp_path_factory):
    """4 PNGs at COCO's two shapes, scaled down, 3-6 boxes of COCO's
    categories each."""
    root = str(tmp_path_factory.mktemp('boxes'))
    synthetic.write_box_set(root, [(120, 160), (160, 120)] * 2, seed=3)
    return root


@pytest.mark.parametrize('flip_ratio', [0.0, 1.0])
def test_train_pipeline_matches_jax(box_set, flip_ratio):
    """LoadImageFromFile -> LoadAnnotations -> Resize(1333, 800) ->
    RandomFlip -> Normalize -> Pad -> DefaultFormatBundle -> Collect, bit
    for bit, with the flip forced off and on."""
    cfg = _coco_train_cfg(box_set, flip_ratio)
    ours, theirs = build_dataset(cfg), j_build_dataset(cfg)
    assert len(ours) == len(theirs) == 4
    np.testing.assert_array_equal(ours.flag, theirs.flag)
    for i in range(len(ours)):
        got, want = ours[i], theirs[i]
        assert sorted(got) == sorted(want) == ['gt_bboxes', 'gt_labels',
                                               'img', 'img_metas']
        assert got['img'].dtype == np.float32 and got['img'].flags.c_contiguous
        assert got['gt_bboxes'].dtype == np.float32
        assert 3 <= len(got['gt_bboxes']) <= 6
        for k in ('img', 'gt_bboxes', 'gt_labels'):
            np.testing.assert_array_equal(got[k], want[k])
        assert got['img_metas']['flip'] == bool(flip_ratio)
        for k, v in want['img_metas'].items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    np.testing.assert_array_equal(got['img_metas'][k][kk], vv)
            else:
                np.testing.assert_array_equal(got['img_metas'][k], v)


def test_collate_train_matches_jax():
    """Three images of two shapes, one with more than ``max_gt`` boxes."""
    rng = np.random.RandomState(0)
    samples = []
    for (h, w), n in (((96, 128), 5), ((128, 100), 130), ((64, 64), 0)):
        samples.append(dict(
            img=rng.randn(h, w, 3).astype(np.float32),
            gt_bboxes=rng.uniform(0, 60, (n, 4)).astype(np.float32),
            gt_labels=rng.randint(0, 80, n).astype(np.int64),
            img_metas=dict(img_shape=(h - 3, w - 5, 3),
                           scale_factor=np.array([1.5] * 4, np.float32))))
    got = collate_train(samples)
    want = collate_detection(samples, static_shapes=None)
    assert sorted(got) == sorted(want)
    assert got['gt_labels'].dtype == torch.int64
    assert tuple(got['img'].shape) == (3, 128, 128, 3)
    for k, v in want.items():
        if k != 'img_metas':
            np.testing.assert_array_equal(got[k].numpy(), v)
    assert int(got['gt_valid'][1].sum()) == 100


@pytest.mark.parametrize('n_flags,bs', [((5, 4), 2), ((7, 2), 3), ((1, 8), 4)])
def test_group_batch_sampler_matches_jax(n_flags, bs):
    """Batches (one aspect group each) and ``len`` for several seeds and
    epochs, shuffled and in order; odd group sizes pad with the group's
    first indices. As in the JAX package, a group smaller than its padding
    (one image at bs4) gives no batch, though ``len`` counts one."""
    flags = np.random.RandomState(sum(n_flags)).permutation(
        np.repeat([0, 1], n_flags))
    for seed in (0, 3):
        for shuffle in (True, False):
            ours = GroupBatchSampler(flags, bs, shuffle, seed)
            theirs = JGroupBatchSampler(flags, bs, shuffle, seed)
            assert len(ours) == len(theirs)
            for epoch in (0, 1, 5):
                ours.epoch = theirs.epoch = epoch
                got, want = list(ours), list(theirs)
                assert len(got) <= len(ours)
                assert [b.tolist() for b in got] == [b.tolist() for b in want]
                for b in got:
                    assert len(set(flags[b])) == 1


def test_grad_clip_matches_optax():
    """SGD with ``grad_clip=dict(max_norm=3)`` against the JAX package's
    chain (``optax.clip_by_global_norm`` over the trainable gradients,
    then the decay and the momentum) over three steps: the first clipped,
    the second not, the third clipped; the frozen gradients (large) count
    for nothing."""
    torch.manual_seed(0)
    net = _Net()
    frozen = frozen_prefixes_from_cfg(dict(backbone=dict(frozen_stages=1)))
    sched = build_lr_schedule(LR_CONFIG, 0.02, 1000)
    opt, scheduler = build_optimizer(SGD, sched, net, frozen)
    clip = build_grad_clip(dict(max_norm=3.0, norm_type=2), opt)
    state = {k: v.detach().numpy().copy() for k, v in net.state_dict().items()
             if not k.endswith('num_batches_tracked')}
    jparams = jax.tree_util.tree_map(jnp.asarray, _nested(state))
    jopt = j_build_optimizer(SGD, j_build_lr_schedule(LR_CONFIG, 0.02, 1000),
                             jparams, j_frozen_prefixes(
                                 dict(backbone=dict(frozen_stages=1))),
                             grad_clip=dict(max_norm=3.0, norm_type=2))
    jstate = jopt.init(jparams)
    update = jax.jit(jopt.update, compiler_options=FAST_COMPILE)
    rng = np.random.RandomState(1)
    for it, scale in enumerate((2.0, 0.1, 5.0)):
        grads = {k: (rng.randn(*v.shape) * (100.0 if k.startswith(
            'backbone.layer1') else scale)).astype(np.float32)
            for k, v in state.items()}
        opt.zero_grad()
        for name, p in net.named_parameters():
            p.grad = torch.from_numpy(grads[name].copy())
        norm = float(clip())
        want_norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                                for k, g in grads.items()
                                if not any(k.startswith(f) for f in frozen)
                                and 'running' not in k))
        assert norm == pytest.approx(want_norm, rel=1e-5)
        assert (norm > 3.0) == (it != 1)
        opt.step()
        scheduler.step()
        updates, jstate = update(
            jax.tree_util.tree_map(jnp.asarray, _nested(grads)), jstate,
            jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams,
                                         updates)
        want = _flat(jparams)
        for name, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name],
                                       rtol=0, atol=1e-6)


def test_grad_clip_refuses_other_norms():
    opt = torch.optim.SGD(_Net().parameters(), lr=0.1)
    assert build_grad_clip(None, opt) is None
    with pytest.raises(NotImplementedError):
        build_grad_clip(dict(max_norm=1.0, norm_type=1), opt)
    with pytest.raises(NotImplementedError):
        build_grad_clip(dict(max_norm=1.0, error_if_nonfinite=True), opt)


# --------------------------------------------------------------------------
# the loop against the JAX package, resume, and the checkpoint in JAX
# --------------------------------------------------------------------------

def _tiny_cfg(cls, root, work_dir):
    """The JAX tool's tiny config (``cls``: either package's ``Config``) on
    the 4-image set: flips off, the LR stepped after epoch 1, the gradient
    clipped at 5, no validation."""
    cfg = cls.fromfile(os.path.join(root, 'cfg.py'))
    cfg.model.neck = cfg.model.neck[0]
    head = cfg.model.roi_head.bbox_head
    head.type = 'Shared2FCBBoxHead'
    head.pop('num_shared_fcs')
    cfg.data.train.pipeline[3].flip_ratio = 0.0
    cfg.lr_config.step = [1]
    cfg.optimizer_config.grad_clip.max_norm = 5.0
    cfg.work_dir = work_dir
    cfg.seed = 0
    return cfg


def _port_run(setup, work_dir, threads=None, resume_from=None, epochs=2):
    """``train_detector`` from the JAX init with the shared priorities;
    returns the log entries, the final state_dict and the work dir."""
    cfg = _tiny_cfg(Config, setup['root'], work_dir)
    cfg.total_epochs = epochs
    if resume_from:
        cfg.resume_from = resume_from
    d = cfg.todict()
    model = build_detector(d['model'], train_cfg=d['train_cfg'],
                           test_cfg=d['test_cfg'])
    model.load_state_dict(setup['state'])
    _patch_torch(model.rpn_head.sampler, *setup['prio'][:2])
    _patch_torch(model.roi_head.sampler, *setup['prio'][2:])
    saved = torch.get_num_threads()
    torch.set_num_threads(threads or saved)
    try:
        history = train_detector(model, build_dataset(d['data']['train']),
                                 cfg, device='cpu')
    finally:
        torch.set_num_threads(saved)
    return dict(history=history, work=work_dir,
                state={k: v.clone() for k, v in model.state_dict().items()})


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    """The set, the starting weights (the port's seeded ones, as a JAX
    parameter tree: no JAX compilation) and the priorities, and the JAX
    package's loop: each iteration's log values and the final
    parameters."""
    root = str(tmp_path_factory.mktemp('loop'))
    synthetic.write_box_set(root, [(128, 160)] * 4, seed=1, categories=BOX)
    with open(os.path.join(root, 'cfg.py'), 'w') as f:
        f.write(e2e_smoke.CFG_TMPL.replace('{root}', root).replace(
            '{epochs}', '2'))
    jcfg = _tiny_cfg(JConfig, root, None).todict()
    jm = j_build_detector(jcfg['model'], train_cfg=jcfg['train_cfg'],
                          test_cfg=jcfg['test_cfg'])
    rng = np.random.RandomState(0)
    model = build_detector(jcfg['model'], train_cfg=jcfg['train_cfg'])
    init_weights(model, torch.Generator().manual_seed(0))
    params = state_dict_to_params(model.state_dict())
    n_anchors = num_anchors(model, 128, 160)
    n_cands = 100 + jcfg['train_cfg']['rpn_proposal']['nms_post']
    prio = [rng.uniform(size=n).astype(np.float32)
            for n in (n_anchors, n_anchors, n_cands, n_cands)]
    _patch_jax(jm.rpn_head.sampler, *prio[:2])
    _patch_jax(jm.roi_head.sampler, *prio[2:])
    stop_roi_gradient(jm)

    loader = j_build_dataloader(j_build_dataset(jcfg['data']['train']),
                                samples_per_gpu=2, workers_per_gpu=0,
                                seed=0, static_shapes=None)
    sched = j_build_lr_schedule(jcfg['lr_config'], 0.01, len(loader))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jopt = j_build_optimizer(
        dict(jcfg['optimizer']), sched, jp,
        j_frozen_prefixes(jcfg['model']),
        grad_clip=jcfg['optimizer_config']['grad_clip'])
    jstate = jopt.init(jp)
    step, logs = None, []
    for epoch in range(2):
        for batch in loader:
            arrays = {k: jnp.asarray(batch[k]) for k in JAX_BATCH_KEYS}
            if step is None:
                step = j_make_train_step(jm, jopt, donate=False).lower(
                    jp, jstate, arrays, jax.random.PRNGKey(0)).compile(
                        FAST_COMPILE)
            jp, jstate, jlogs = step(jp, jstate, arrays,
                                     jax.random.PRNGKey(0))
            logs.append({k: float(v) for k, v in jlogs.items()})
    return dict(root=root, jm=jm, params=params,
                state=params_to_state_dict(params),
                prio=[torch.from_numpy(p).numpy() for p in prio],
                jlogs=logs, jparams=params_to_state_dict(
                    jax.tree_util.tree_map(np.array, jp)))


@pytest.fixture(scope='module')
def runs(setup, tmp_path_factory):
    """The port's loop with all CPU threads and with one: the same run when
    the module runs on one thread (``test_torch_threads``), and then done
    once."""
    base = tmp_path_factory.mktemp('runs')
    out = {'all': _port_run(setup, str(base / 'all'))}
    out['one'] = out['all'] if torch.get_num_threads() == 1 else _port_run(
        setup, str(base / 'one'), 1)
    return out


def _differences(run, ref, setup):
    """``run``'s iterations and, against ``ref`` (a run's log entries and
    state), each iteration's largest relative loss difference and each
    parameter's largest difference over its largest update in the JAX
    loop (the starting weights to the JAX package's final ones)."""
    train = [e for e in run['history'] if e['mode'] == 'train']
    loss = max(abs(e[k] - j[k]) / max(abs(j[k]), 1e-6)
               for e, j in zip(train, ref['logs']) for k in j)
    weights = 0.0
    for k, v in setup['jparams'].items():
        moved = float((v - setup['state'][k]).abs().max())
        if moved > 0:
            weights = max(weights, float(
                (run['state'][k] - ref['state'][k]).abs().max()) / moved)
    return len(train), loss, weights


def _jax_ref(setup):
    return dict(logs=setup['jlogs'], state=setup['jparams'])


def _tolerance(runs, setup):
    """As ``train/bench.py`` states its card-against-CPU tolerance: a floor
    plus 4x the spread between the port's loop on one CPU thread and on
    all. The floors: 1e-5 of a loss (the loop reads 4.3e-7); 1e-2 of a
    parameter's update: XLA and PyTorch sum in other orders, and a
    parameter that moves by a few hundred ulps in 4 steps ends one ulp
    apart (the loop reads 2.4e-3 on an FPN conv that moved 3.1e-6 at |p| ~
    0.07, 1.3e-4 on BatchNorm biases that start at 0). A skipped scheduler
    step reads 0.6 and 1.0."""
    one = runs['one']
    _, spread_l, spread_w = _differences(
        runs['all'], dict(logs=[{k: e[k] for k in setup['jlogs'][0]}
                                for e in one['history']
                                if e['mode'] == 'train'],
                          state=one['state']), setup)
    return 1e-5 + 4 * spread_l, 1e-2 + 4 * spread_w


def test_loop_matches_jax(runs, setup):
    """Each iteration's losses and the final weights of 2 epochs x 2
    iterations against the JAX package's optimizer and train step."""
    n, loss, weights = _differences(runs['all'], _jax_ref(setup), setup)
    tol_l, tol_w = _tolerance(runs, setup)
    assert n == 4 == len(setup['jlogs'])
    assert loss <= tol_l and weights <= tol_w, (loss, tol_l, weights, tol_w)
    lrs = [e['lr'] for e in runs['all']['history']]
    sched = build_lr_schedule(dict(LR_CONFIG, warmup_iters=5, step=[1]),
                              0.01, 2)
    assert lrs == pytest.approx([sched(i) for i in range(1, 5)], rel=1e-6)
    assert lrs[1] < lrs[0]                   # stepped after epoch 1


def test_loop_check_catches_a_skipped_scheduler_step(runs, setup, tmp_path,
                                                     monkeypatch):
    """A loop that never steps the LR stays at the warm-up's first LR: the
    comparison above must fail."""
    from arfe_tpu_torch.apis import train as train_api
    make = train_api.make_train_step
    monkeypatch.setattr(train_api, 'make_train_step',
                        lambda m, o, s, g: make(m, o, None, g))
    _, loss, weights = _differences(_port_run(setup, str(tmp_path)),
                                    _jax_ref(setup), setup)
    tol_l, tol_w = _tolerance(runs, setup)
    assert loss > tol_l or weights > tol_w


def test_resume_equals_the_uninterrupted_run(runs, setup, tmp_path):
    """One thread: epoch 2 resumed from the uninterrupted run's
    ``epoch_1.pth`` ends at the same weights, momentum buffers, LR and
    log lines, bit for bit."""
    one = runs['one']['work']
    got_run = _port_run(setup, str(tmp_path), 1,
                        os.path.join(one, 'epoch_1.pth'))
    history, state = got_run['history'], got_run['state']
    want_history, want_state = runs['one']['history'], runs['one']['state']
    assert history == [e for e in want_history if e['epoch'] == 2]
    for k, v in want_state.items():
        assert torch.equal(state[k], v), k
    got = torch.load(tmp_path / 'epoch_2.pth', weights_only=True)
    want = torch.load(os.path.join(one, 'epoch_2.pth'), weights_only=True)
    assert got['scheduler'] == want['scheduler']
    assert got['meta']['epoch'] == 2 and got['meta']['iter'] == 4
    bufs = [(s['momentum_buffer'], want['optimizer']['state'][i][
        'momentum_buffer']) for i, s in got['optimizer']['state'].items()]
    assert len(bufs) > 50 and all(torch.equal(a, b) for a, b in bufs)
    assert got['optimizer']['param_groups'] == want['optimizer'][
        'param_groups']
    with open(tmp_path / 'train.log.json') as f:
        lines = [json.loads(line) for line in f]
    assert lines == history and len(lines) == 2
    assert os.readlink(tmp_path / 'latest.pth') == 'epoch_2.pth'


def test_jax_reads_the_port_checkpoint(runs, setup):
    """The JAX package's ``load_checkpoint`` reads the port's
    ``epoch_2.pth``; its ``simple_test`` gives the port's detections."""
    path = os.path.join(runs['all']['work'], 'epoch_2.pth')
    params, meta, _ = j_load_checkpoint(path)
    assert meta['epoch'] == 2 and list(meta['CLASSES']) == ['box']
    cfg = _tiny_cfg(Config, setup['root'], None)
    model = init_detector(cfg, path, device='cpu')
    img = (np.random.RandomState(4).randn(1, 128, 160, 3) * 0.5).astype(
        np.float32)
    shapes = np.array([[128., 160.]], np.float32)
    scales = np.ones((1, 4), np.float32)
    jm = setup['jm']
    want = jax.jit(lambda p, *a: jm.simple_test(p, *a, rescale=True),
                   compiler_options=FAST_COMPILE)(
        params, *(jnp.asarray(a) for a in (img, shapes, scales)))
    got = model.simple_test(*(torch.from_numpy(a) for a in (img, shapes,
                                                            scales)),
                            rescale=True)
    valid = np.asarray(want[2])
    assert valid.sum() > 0
    np.testing.assert_array_equal(got[2].numpy(), valid)
    np.testing.assert_array_equal(got[1].numpy()[valid],
                                  np.asarray(want[1])[valid])
    np.testing.assert_allclose(got[0].numpy()[valid],
                               np.asarray(want[0])[valid], rtol=1e-4,
                               atol=1e-3)


def test_pth_classes_reach_both_packages(setup, tmp_path):
    """``meta['CLASSES']`` of a ``.pth`` becomes the model's ``CLASSES`` in
    the port's ``init_detector``, as in the JAX package's."""
    cfg = _tiny_cfg(Config, setup['root'], None)
    model = build_detector(cfg.todict()['model'])
    model.load_state_dict(setup['state'])
    path = save_checkpoint(str(tmp_path / 'box.pth'), model,
                           meta={'CLASSES': ('box',)})
    assert tuple(init_detector(cfg, path, device='cpu').CLASSES) == ('box',)
    jcfg = _tiny_cfg(JConfig, setup['root'], None)
    assert tuple(j_init_detector(jcfg, path).CLASSES) == ('box',)


def test_pretrained_backbone_matches_jax(setup, tmp_path, monkeypatch):
    """A torchvision-style state_dict (with ``fc.*`` and BatchNorm
    counters) at ``$ARFE_PRETRAINED_DIR/resnet18.pth`` maps onto the
    backbone as in the JAX package; without the file both raise
    ``FileNotFoundError`` with the same words."""
    cfg = _tiny_cfg(Config, setup['root'], None).todict()
    rng = np.random.RandomState(7)
    src = build_detector(cfg['model']).backbone.state_dict()
    tv = {k: torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
          for k, v in src.items()}
    tv.update({'fc.weight': torch.ones(1000, 512),
               'fc.bias': torch.zeros(1000),
               'bn1.num_batches_tracked': torch.tensor(5)})
    torch.save(tv, tmp_path / 'resnet18.pth')
    monkeypatch.setenv('ARFE_PRETRAINED_DIR', str(tmp_path))
    model = build_detector(cfg['model'])
    model.load_state_dict(setup['state'])
    load_pretrained_backbone('torchvision://resnet18', model, log=print)
    jparams = {'backbone': jax.tree_util.tree_map(
        np.copy, setup['params']['backbone'])}
    want = params_to_state_dict(j_load_pretrained_backbone(
        'torchvision://resnet18', jparams, log=print)['backbone'])
    got = model.backbone.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
        assert torch.equal(got[k], tv[k]), k
    monkeypatch.setenv('ARFE_PRETRAINED_DIR', str(tmp_path / 'none'))
    with pytest.raises(FileNotFoundError) as ours:
        load_pretrained_backbone('torchvision://resnet50', model)
    with pytest.raises(FileNotFoundError) as theirs:
        j_load_pretrained_backbone('torchvision://resnet50', jparams)
    assert str(ours.value) == str(theirs.value)


def test_train_cli_raises_without_the_pretrained_file(setup, tmp_path,
                                                      monkeypatch):
    """``pretrained='torchvision://resnet50'`` of the flagship configs, with
    no file: the CLI stops before training, with the JAX package's words."""
    monkeypatch.setenv('ARFE_PRETRAINED_DIR', str(tmp_path))
    with pytest.raises(FileNotFoundError, match='cannot download weights'):
        train_cli.main([os.path.join(setup['root'], 'cfg.py'), '--device',
                        'cpu', '--work-dir', str(tmp_path / 'work'),
                        '--options',
                        'model.pretrained=torchvision://resnet50'])
    assert not os.path.exists(tmp_path / 'work' / 'epoch_1.pth')


def test_train_cli_defaults_to_cuda(setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_cli.main([os.path.join(setup['root'], 'cfg.py'), '--work-dir',
                        str(tmp_path)])


def test_e2e_smoke_passes_on_the_cpu(tmp_path, capsys):
    """``python -m arfe_tpu_torch.tools.e2e_smoke --device cpu``, in
    process: train (AR-FPN, AR-RFF head, clipped), resume, test --eval
    bbox, each with a finite loss or mAP."""
    assert e2e_smoke.main(['--device', 'cpu', '--root', str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out['ok'] and out['stages']['train']['n'] == 8
    assert out['stages']['resume']['n'] == 4
    assert out['stages']['resume']['last_loss'] == pytest.approx(
        out['stages']['train']['last_loss'], rel=1e-4)
