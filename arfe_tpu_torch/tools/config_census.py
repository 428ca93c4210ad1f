"""How many of the repository's configs the port builds.

    python -m arfe_tpu_torch.tools.config_census [--configs DIR] [--list]

For each config under ``configs/`` outside ``_base_``, builds the port's
detector with the config's ``train_cfg`` and ``test_cfg`` on the ``meta``
device (no weights are made) and ``Compose`` over its train and test
pipelines (each of a list-valued ``data.train``). Prints the configs that
stop, grouped by the first error each meets, then one JSON line with the
counts. Runs on the CPU in seconds.
"""
from __future__ import annotations

import argparse
import collections
import glob
import json
import os

import torch

from ..config import Config
from ..data import Compose
from ..models import build_detector


def check(path):
    """None if the config at ``path`` builds, else the error's text."""
    try:
        cfg = Config.fromfile(path).todict()
        model = dict(cfg['model'])
        model.pop('pretrained', None)
        with torch.device('meta'):
            build_detector(model, train_cfg=cfg.get('train_cfg'),
                           test_cfg=cfg.get('test_cfg'))
        data = cfg.get('data') or {}
        train = data.get('train') or []
        for split in (train if isinstance(train, list) else [train]) \
                + [data.get('test') or {}]:
            if 'pipeline' in split:
                Compose(split['pipeline'])
    except Exception as e:  # noqa: BLE001 - the census records any stop
        return f'{type(e).__name__}: {e}'.splitlines()[0][:120]
    return None


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--configs', default='configs')
    parser.add_argument('--list', action='store_true',
                        help='print every config that stops')
    args = parser.parse_args(argv)
    paths = sorted(p for p in glob.glob(os.path.join(args.configs, '**',
                                                     '*.py'), recursive=True)
                   if '_base_' not in p)
    stops = {p: check(p) for p in paths}
    by_error = collections.defaultdict(list)
    for p, err in stops.items():
        if err is not None:
            by_error[err].append(os.path.relpath(p, args.configs))
    for err, names in sorted(by_error.items(), key=lambda e: -len(e[1])):
        print(f'{len(names):3d}  {err}')
        if args.list:
            for n in names:
                print(f'       {n}')
    built = sum(err is None for err in stops.values())
    print(json.dumps({'configs': len(paths), 'built': built,
                      'stopped': len(paths) - built}))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
