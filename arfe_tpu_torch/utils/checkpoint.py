"""The JAX package's native checkpoint, read without JAX.

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
import pickle

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


def load_checkpoint(path):
    """``(state_dict, meta)`` of a native ``.pkl`` checkpoint: the parameter
    tree through ``params_to_state_dict``, and the saved ``meta`` (epoch,
    CLASSES, config text). The optimizer state is not loaded."""
    with open(path, 'rb') as f:
        ckpt = _CheckpointUnpickler(f).load()
    if not isinstance(ckpt, dict) or 'state_dict' not in ckpt:
        raise ValueError(f'{path}: not a checkpoint of the JAX package')
    return params_to_state_dict(ckpt['state_dict']), dict(ckpt.get('meta')
                                                          or {})
