"""Train a detector from its config (counterpart of ``tools/train.py:13-89``;
ref: tools/train.py:19-150).

    python -m arfe_tpu_torch.tools.train CONFIG [--work-dir D]
        [--resume-from CKPT] [--no-validate] [--seed N] [--deterministic]
        [--options k=v ...] [--autoscale-lr] [--device cuda|cpu]
        [--dtype f32|bf16]

Writes into the work dir (default ``./work_dirs/<config name>``) the
config, a timestamped text log, ``train.log.json`` and ``epoch_{e}.pth``
checkpoints with ``latest.pth`` pointing at the newest. The weights start
from a ``torch.Generator`` seeded with ``--seed`` (0 by default), or from
the model's ``pretrained`` backbone, ``load_from`` or ``--resume-from``.
``--device`` defaults to the card; ``--dtype`` is the images' dtype there:
f32 (the default, the JAX package's arithmetic) or bf16, the card's fast
path.
"""
from __future__ import annotations

import argparse
import ast
import os
import os.path as osp
import time

import torch

from ..apis import set_random_seed, train_detector
from ..config import Config
from ..data import build_dataset
from ..layers import init_weights
from ..models import build_detector
from ..utils import collect_env, get_root_logger

DTYPES = {'f32': torch.float32, 'bf16': torch.bfloat16}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Train a detector')
    parser.add_argument('config', help='train config file path')
    parser.add_argument('--work-dir', help='dir to save logs and ckpts')
    parser.add_argument('--resume-from', help='checkpoint to resume from')
    parser.add_argument('--no-validate', action='store_true')
    parser.add_argument('--seed', type=int, default=None)
    parser.add_argument('--deterministic', action='store_true')
    parser.add_argument('--options', nargs='+', default=[],
                        help='k=v config overrides (dotted keys)')
    parser.add_argument('--autoscale-lr', action='store_true',
                        help='scale lr linearly with device count / 8 '
                             '(ref: tools/train.py:90-92)')
    parser.add_argument('--device', default='cuda',
                        help='cuda (default) or cpu')
    parser.add_argument('--dtype', choices=sorted(DTYPES), default='f32')
    return parser.parse_args(argv)


def main(argv=None):
    """Runs the CLI; returns ``train_detector``'s log entries."""
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    if args.options:
        overrides = {}
        for kv in args.options:
            k, v = kv.split('=', 1)
            try:
                v = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                pass
            overrides[k] = v
        cfg.merge_from_dict(overrides)
    if args.work_dir is not None:
        cfg['work_dir'] = args.work_dir
    elif cfg.get('work_dir') is None:
        cfg['work_dir'] = osp.join(
            './work_dirs', osp.splitext(osp.basename(args.config))[0])
    if args.resume_from is not None:
        cfg['resume_from'] = args.resume_from
    if args.seed is not None:
        cfg['seed'] = args.seed
        set_random_seed(args.seed, deterministic=args.deterministic)
    if args.autoscale_lr:
        # one device: the reference's rule, lr * gpus / 8
        cfg['optimizer']['lr'] = cfg['optimizer']['lr'] / 8

    os.makedirs(cfg['work_dir'], exist_ok=True)
    timestamp = time.strftime('%Y%m%d_%H%M%S', time.localtime())
    logger = get_root_logger(osp.join(cfg['work_dir'], f'{timestamp}.log'))
    env = collect_env()
    logger.info('Environment:\n' + '\n'.join(
        f'{k}: {v}' for k, v in env.items()))
    cfg.dump(osp.join(cfg['work_dir'], osp.basename(args.config)))

    cfg_dict = cfg.todict()
    model = build_detector(cfg_dict['model'],
                           train_cfg=cfg_dict.get('train_cfg'),
                           test_cfg=cfg_dict.get('test_cfg'))
    init_weights(model, torch.Generator().manual_seed(cfg.get('seed') or 0))
    dataset = build_dataset(cfg_dict['data']['train'])
    logger.info(f'dataset: {len(dataset)} images')
    return train_detector(model, dataset, cfg,
                          validate=not args.no_validate, logger=logger,
                          device=args.device, dtype=DTYPES[args.dtype])


if __name__ == '__main__':
    main()
