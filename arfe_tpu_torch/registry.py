"""String-keyed registries mapping config ``type='X'`` tags to constructors.

The port's own copy of ``arfe_tpu/registry.py`` (the port imports nothing of
the JAX package), with the registries the inference, training and
evaluation paths use.
"""
from __future__ import annotations

import inspect


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._module_dict: dict[str, type] = {}

    @property
    def name(self):
        return self._name

    @property
    def module_dict(self):
        return self._module_dict

    def get(self, key: str):
        return self._module_dict.get(key)

    def __contains__(self, key):
        return key in self._module_dict

    def __repr__(self):
        return f'Registry(name={self._name}, items={list(self._module_dict)})'

    def register_module(self, name: str | None = None, module: type | None = None):
        if module is not None:
            self._register(module, name)
            return module

        def _wrapper(cls):
            self._register(cls, name)
            return cls

        return _wrapper

    def _register(self, cls, name=None):
        if not inspect.isclass(cls) and not inspect.isfunction(cls):
            raise TypeError(f'module must be a class or function, got {type(cls)}')
        key = name if name is not None else cls.__name__
        if key in self._module_dict:
            raise KeyError(f'{key} is already registered in {self._name}')
        self._module_dict[key] = cls


def build_from_cfg(cfg, registry: Registry, default_args: dict | None = None):
    """Instantiate ``registry[cfg['type']](**cfg_without_type, **default_args)``."""
    if not isinstance(cfg, dict) or 'type' not in cfg:
        raise TypeError(f'cfg must be a dict with a "type" key, got {cfg!r}')
    args = dict(cfg)
    obj_type = args.pop('type')
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f'{obj_type} is not in the {registry.name} registry')
    elif inspect.isclass(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f'type must be a str or class, got {type(obj_type)}')
    if default_args is not None:
        for k, v in default_args.items():
            args.setdefault(k, v)
    return obj_cls(**args)


# Model-side registries (ref: mmdet/models/builder.py:4-10)
BACKBONES = Registry('backbone')
NECKS = Registry('neck')
ROI_EXTRACTORS = Registry('roi_extractor')
HEADS = Registry('head')
DETECTORS = Registry('detector')

LOSSES = Registry('loss')

# Core registries
BBOX_ASSIGNERS = Registry('bbox_assigner')
BBOX_SAMPLERS = Registry('bbox_sampler')
BBOX_CODERS = Registry('bbox_coder')
ANCHOR_GENERATORS = Registry('anchor_generator')

# Data registries (ref: mmdet/datasets/builder.py, pipelines/compose.py)
DATASETS = Registry('dataset')
PIPELINES = Registry('pipeline')
