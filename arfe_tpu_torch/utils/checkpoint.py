"""Checkpoints: the port's ``.pth`` (written by the training run), mmdet's
``.pth`` and the JAX package's native ``.pkl``, read without JAX.

:func:`save_checkpoint` writes mmcv's layout, ``{'meta': dict,
'state_dict': the model's state_dict, 'optimizer': optimizer.state_dict(),
'scheduler': scheduler.state_dict()}``, with the weights on the CPU, which
``torch.load(weights_only=True)`` reads. Its state_dict names are the
reference's, which the JAX package's ``load_torch_checkpoint`` reads too
(``arfe_tpu/convert/torch2jax.py:68-80``).

``arfe_tpu.utils.save_checkpoint`` writes a pickle of ``{'meta': dict,
'state_dict': nested dict of numpy arrays, 'optimizer': optax state}``
(``arfe_tpu/utils/checkpoint.py:73-79``). The optimizer state holds optax's
named tuples, so a plain ``pickle.load`` would import optax and with it
JAX. :class:`_CheckpointUnpickler` admits numpy, builtins' plain types and
``collections``, and gives an inert placeholder for any other class; only
the parameters and ``meta`` are kept.
"""
from __future__ import annotations

import builtins
import collections
import importlib
import os
import pickle

import torch

from .. import __version__
from ..convert import params_to_state_dict

_BUILTINS = frozenset((
    'bool', 'bytearray', 'bytes', 'complex', 'dict', 'float', 'frozenset',
    'int', 'list', 'object', 'range', 'set', 'slice', 'str', 'tuple'))


class _Placeholder:
    """Stands in for a class the port does not load (an optax state): takes
    whatever the pickle gives it and does nothing."""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args = args
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


class _CheckpointUnpickler(pickle.Unpickler):

    def find_class(self, module, name):
        if module == 'builtins':
            if name not in _BUILTINS:
                raise pickle.UnpicklingError(f'builtins.{name} is not read')
            return getattr(builtins, name)
        if module == 'collections':
            return getattr(collections, name)
        if module == 'numpy' or module.startswith('numpy.'):
            return getattr(_numpy_module(module), name)
        return type(name, (_Placeholder,), {'__module__': module})


def _numpy_module(module):
    """numpy 2 pickles name ``numpy._core``, which numpy 1 calls
    ``numpy.core`` (numpy 2 still reads ``numpy.core``, with a warning):
    either name is read under the one this numpy has."""
    parts = module.split('.')
    if parts[1:2] in (['_core'], ['core']):
        for core in ('_core', 'core'):
            try:
                return importlib.import_module(
                    '.'.join(['numpy', core] + parts[2:]))
            except ImportError:
                continue
    return importlib.import_module(module)


def save_checkpoint(path, model, optimizer=None, scheduler=None, meta=None):
    """Write ``model``'s state_dict (on the CPU), the optimizer's and the
    scheduler's states and ``meta`` (with ``arfe_tpu_torch_version``) to
    ``path``, through a temporary file, so that an interrupted save leaves
    no partial checkpoint."""
    meta = dict(meta or {})
    meta.setdefault('arfe_tpu_torch_version', __version__)
    ckpt = {'meta': meta,
            'state_dict': {k: v.detach().cpu().contiguous()
                           for k, v in model.state_dict().items()}}
    if optimizer is not None:
        ckpt['optimizer'] = optimizer.state_dict()
    if scheduler is not None:
        ckpt['scheduler'] = scheduler.state_dict()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f'{path}.tmp'
    torch.save(ckpt, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path):
    """``(state_dict, meta, optimizer, scheduler)`` of a checkpoint.

    A ``.pkl`` is the JAX package's: its parameter tree through
    ``params_to_state_dict`` and its ``meta`` (epoch, CLASSES, config
    text); its optax state is not loaded (``None``, ``None``). Any other
    file is a ``.pth`` read with ``torch.load(weights_only=True)``: the
    port's (:func:`save_checkpoint`), mmdet's ``{'state_dict', 'meta'}`` or
    a bare state_dict, with ``module.`` prefixes stripped and
    ``num_batches_tracked`` counters (frozen BatchNorm keeps none) dropped;
    ``optimizer`` and ``scheduler`` are ``None`` where the file has none.
    """
    if str(path).endswith('.pkl'):
        with open(path, 'rb') as f:
            ckpt = _CheckpointUnpickler(f).load()
        if not isinstance(ckpt, dict) or 'state_dict' not in ckpt:
            raise ValueError(f'{path}: not a checkpoint of the JAX package')
        return (params_to_state_dict(ckpt['state_dict']),
                dict(ckpt.get('meta') or {}), None, None)
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    state = ckpt['state_dict'] if 'state_dict' in ckpt else ckpt
    state = {(k[7:] if k.startswith('module.') else k): v
             for k, v in state.items()
             if not k.endswith('num_batches_tracked')}
    if 'state_dict' not in ckpt:
        return state, {}, None, None
    return (state, dict(ckpt.get('meta') or {}), ckpt.get('optimizer'),
            ckpt.get('scheduler'))
