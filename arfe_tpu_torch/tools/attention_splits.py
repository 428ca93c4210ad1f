"""Kernel A's bf16 time at each key-split count, on the card.

    python -m arfe_tpu_torch.tools.attention_splits [--rounds 3]

At AR-FPN's refine shape (N = 4200 tokens of the stride-16 level at
800x1344, C = 256, bf16, unscaled), for B = 1 and B = 2, times on the same
inputs every split count that leaves no split without a key tile, by
CUDA-graph replay (device time), in ``--rounds`` rounds that each time
every count once. Then times ``fused_attention_cuda`` with the count
``key_splits`` picks, by graph replay and by an event loop of back-to-back
calls, which also holds the wrapper's host time when that is the longer.
Prints the card's name and power limit, one line per count (median, min
and max over the rounds) and one JSON line of all readings.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import fused_attention as fa
from .timing import card, cuda_ms

N, C = 4200, 256


def split_counts(n):
    """The split counts that give every split at least one key tile."""
    tiles = -(-n // fa.KEY_TILE)
    return [s for s in range(1, min(tiles, fa.MOST_SPLITS) + 1)
            if -(-tiles // -(-tiles // s)) == s]


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--rounds', type=int, default=3)
    args = parser.parse_args()
    print(card())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device='cuda').manual_seed(0)
    result = {}
    for b in (1, 2):
        q, k, v = (torch.randn((b, N, C), generator=gen, device='cuda')
                   .to(torch.bfloat16) for _ in range(3))
        counts = split_counts(N)
        ms = {s: [] for s in counts}
        for _ in range(args.rounds):
            for s in counts:
                ms[s].append(cuda_ms(lambda s=s: fa._launch(q, k, v, None, s),
                                     graph=True))
        picked = fa.key_splits(b, N, sms)
        def wrapper():
            return fa.fused_attention_cuda(q, k, v)
        graph_ms = cuda_ms(wrapper, graph=True)
        loop_ms = cuda_ms(wrapper)
        for s in counts:
            blocks = -(-N // 64) * b * s
            print(f'B={b} splits {s:2d} ({blocks:4d} blocks): median '
                  f'{np.median(ms[s]):.4f} ms, min {min(ms[s]):.4f}, max '
                  f'{max(ms[s]):.4f}{"  <- key_splits" if s == picked else ""}')
        print(f'B={b} fused_attention_cuda ({picked} splits): graph '
              f'{graph_ms:.4f} ms, event loop {loop_ms:.4f} ms')
        result[f'B={b}'] = dict(
            key_splits=picked, graph_ms=graph_ms, event_loop_ms=loop_ms,
            splits_ms={s: float(np.median(t)) for s, t in ms.items()})
    print(json.dumps(result))


if __name__ == '__main__':
    main()
