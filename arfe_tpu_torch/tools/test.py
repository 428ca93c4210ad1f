"""Evaluate a detector on its config's test set (counterpart of
``tools/test.py:27-79``, one image a batch).

    python -m arfe_tpu_torch.tools.test CONFIG [CHECKPOINT] [--eval bbox [segm]]
        [--out F.pkl] [--device cuda|cpu]

The checkpoint is the JAX package's native ``.pkl`` or an mmdet-style
``.pth``; without one the weights are random. ``--device`` defaults to the
card. Prints each metric as ``name: value``.
"""
from __future__ import annotations

import argparse
import pickle

from ..apis import init_detector, single_device_test
from ..config import Config
from ..data import build_dataloader, build_dataset

def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Test a detector')
    parser.add_argument('config')
    parser.add_argument('checkpoint', nargs='?', default=None)
    parser.add_argument('--out', help='output result file (.pkl)')
    parser.add_argument('--eval', type=str, nargs='+',
                        help="metrics: bbox, and segm for a mask model")
    parser.add_argument('--device', default='cuda',
                        help='cuda (default) or cpu')
    return parser.parse_args(argv)


def build_test_loader(cfg):
    """The config's test dataset and its loader: one image a batch, read in
    ``data.workers_per_gpu`` worker processes."""
    data = cfg.todict()['data']
    dataset = build_dataset(data['test'], dict(test_mode=True))
    loader = build_dataloader(dataset, samples_per_gpu=1,
                              workers_per_gpu=data.get('workers_per_gpu', 2))
    return dataset, loader


def main(argv=None):
    """Runs the CLI; returns the metrics (empty without ``--eval``)."""
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    if not args.checkpoint:
        print('WARNING: no checkpoint given — random weights')
    model = init_detector(cfg, args.checkpoint, device=args.device)
    dataset, loader = build_test_loader(cfg)
    results = single_device_test(model, loader)
    if args.out:
        with open(args.out, 'wb') as f:
            pickle.dump(results, f)
        print(f'results written to {args.out}')
    metrics = dataset.evaluate(results, metric=args.eval) if args.eval \
        else {}
    for k, v in metrics.items():
        print(f'{k}: {v:.4f}' if isinstance(v, float) else f'{k}: {v}')
    return metrics


if __name__ == '__main__':
    main()
