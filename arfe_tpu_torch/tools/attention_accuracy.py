"""Kernel A's f32 accuracy at AR-FPN's refine shape, on the card.

    python -m arfe_tpu_torch.tools.attention_accuracy [--seeds 10]

For B = 1 and B = 2 at N = 4200, C = 256 (unscaled; q, k, v randn from a
seeded generator per seed), holds three f32 attentions against an f64
reference, ``softmax(q k^T) v`` computed in float64: the kernel (3xTF32),
the plain version (``attention_plain``: cuBLAS f32 products, the reference
of ``chip_smoke.py`` and the card tests) and SDPA in f32. Then the kernel
and SDPA against the plain version, the comparison that the kernel's 1e-4
tolerance is stated for. Prints the card's name and power limit, the
minimum, median and maximum of each largest error over the seeds, and one
JSON line of them.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import fused_attention as fa
from .timing import card

N, C = 4200, 256


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--seeds', type=int, default=10)
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card())
    result = {}
    for b in (1, 2):
        errs = {k: [] for k in ('kernel_vs_f64', 'plain_vs_f64', 'sdpa_vs_f64',
                                'kernel_vs_plain', 'sdpa_vs_plain')}
        for seed in range(args.seeds):
            gen = torch.Generator(device='cuda').manual_seed(100 + seed)
            q, k, v = (torch.randn((b, N, C), generator=gen, device='cuda')
                       for _ in range(3))
            exact = torch.softmax(q.double() @ k.double().transpose(-1, -2),
                                  -1) @ v.double()
            got = {'kernel': fa.fused_attention_cuda(q, k, v),
                   'plain': fa.attention_plain(q, k, v),
                   'sdpa': F.scaled_dot_product_attention(
                       q[:, None], k[:, None], v[:, None], scale=1.0)[:, 0]}
            for name, out in got.items():
                errs[f'{name}_vs_f64'].append(
                    (out.double() - exact).abs().max().item())
            for name in ('kernel', 'sdpa'):
                errs[f'{name}_vs_plain'].append(
                    (got[name] - got['plain']).abs().max().item())
            del exact
        row = {}
        for name, e in errs.items():
            row[name] = dict(min=min(e), median=float(np.median(e)), max=max(e))
            print(f'B={b} {name}: min {min(e):.3e}, median '
                  f'{np.median(e):.3e}, max {max(e):.3e} over {len(e)} seeds')
        result[f'B={b}'] = row
    print(json.dumps(result))


if __name__ == '__main__':
    main()
