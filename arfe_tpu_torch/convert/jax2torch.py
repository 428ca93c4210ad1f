"""JAX parameter tree -> PyTorch ``state_dict`` (the inverse of
``arfe_tpu/convert/torch2jax.py:26-65``, ``tensor_to_array`` /
``state_dict_to_params``).

The JAX package's parameter paths already are the reference's ``state_dict``
names, so the conversion joins the nested keys with dots and transposes conv
kernels HWIO -> OIHW. The mask head's transposed conv (``upsample.weight``)
is stored by the JAX package as the spatially flipped HWIO kernel of the
equivalent convolution (``arfe_tpu/convert/torch2jax.py:18-32``); torch's
``ConvTranspose2d`` takes IOHW unflipped, so it is flipped back and
transposed HWIO -> IOHW. Linear weights stay (out, in); norm children stay
``bn``. The result loads with ``load_state_dict(strict=True)``.
"""
from __future__ import annotations

import numpy as np
import torch

#: transposed-conv weights (the mask head's 2x deconvolution)
TRANSPOSED_CONV_SUFFIXES = ('upsample.weight',)


def params_to_state_dict(params, prefix=''):
    """Flatten a nested dict of numpy arrays into ``{dotted name: tensor}``."""
    out = {}
    for key, val in params.items():
        name = f'{prefix}{key}'
        if isinstance(val, dict):
            out.update(params_to_state_dict(val, name + '.'))
            continue
        arr = np.asarray(val, dtype=np.float32)
        if arr.ndim == 4 and name.endswith(TRANSPOSED_CONV_SUFFIXES):
            arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)   # flip, -> IOHW
        elif arr.ndim == 4 and name.endswith('weight'):
            arr = arr.transpose(3, 2, 0, 1)   # HWIO -> OIHW
        out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
