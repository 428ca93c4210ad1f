"""Environment report (the port's counterpart of
``arfe_tpu/utils/collect_env.py``; ref: mmdet/utils/collect_env.py:14):
Python, PyTorch, CUDA, the cards and ``nvcc``."""
from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch


def collect_env():
    from .. import __version__
    from ..ops.cuda_build import _nvcc
    env = {
        'sys.platform': sys.platform,
        'Python': sys.version.replace('\n', ''),
        'PyTorch': torch.__version__,
        'CUDA (PyTorch built with)': str(torch.version.cuda),
        'numpy': np.__version__,
    }
    if torch.cuda.is_available():
        env['GPU'] = ', '.join(torch.cuda.get_device_name(i)
                               for i in range(torch.cuda.device_count()))
    else:
        env['GPU'] = 'none'
    try:
        out = subprocess.run([_nvcc(), '--version'], capture_output=True,
                             text=True, timeout=60).stdout
        env['NVCC'] = out.strip().splitlines()[-1] if out.strip() else '?'
    except (RuntimeError, OSError, subprocess.SubprocessError):
        env['NVCC'] = 'not found'
    env['arfe_tpu_torch'] = __version__
    return env
