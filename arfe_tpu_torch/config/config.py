"""Python-file config loader with ``_base_`` inheritance.

Re-implements the config semantics the reference's configs are written in
(mmcv ``Config.fromfile``; used at ref: tools/train.py:68, with ``_base_``
composition as in ref: configs/mytrain/retinanet_r50_drfpn_1x_coco.py:1-5 and
``_delete_=True`` overrides as in ref:
configs/_base_/models/faster_fsaf_r50_fpn.py:60), so reference-style configs
load unchanged.

The port's own copy of ``arfe_tpu/config/config.py``: the port imports
nothing of the JAX package.
"""
from __future__ import annotations

import os
import os.path as osp
import types


class ConfigDict(dict):
    """Dict with attribute access; missing attribute raises AttributeError."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(
                f"'ConfigDict' object has no attribute '{name}'")

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name)

    def copy(self):
        return ConfigDict(self)


DELETE_KEY = '_delete_'
BASE_KEY = '_base_'
RESERVED_KEYS = ('filename', 'text')


def _to_config_dict(obj):
    if isinstance(obj, dict):
        return ConfigDict({k: _to_config_dict(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_config_dict(v) for v in obj)
    return obj


def _merge_a_into_b(a: dict, b: dict) -> dict:
    """Deep-merge dict ``a`` (override) into dict ``b`` (base)."""
    b = dict(b)
    for k, v in a.items():
        if isinstance(v, dict) and k in b and not v.pop(DELETE_KEY, False) \
                and isinstance(b[k], dict):
            b[k] = _merge_a_into_b(v, b[k])
        else:
            if isinstance(v, dict):
                v = dict(v)
                v.pop(DELETE_KEY, None)
            b[k] = v
    return b


def _load_py_file(filename: str) -> dict:
    with open(filename) as f:
        src = f.read()
    mod = types.ModuleType('_arfe_cfg')
    mod.__file__ = filename
    code = compile(src, filename, 'exec')
    exec(code, mod.__dict__)
    return {
        k: v for k, v in mod.__dict__.items()
        if not k.startswith('__') and not isinstance(v, types.ModuleType)
        and not callable(v)
    }


def _load_with_bases(filename: str) -> tuple[dict, str]:
    filename = osp.abspath(osp.expanduser(filename))
    cfg_dict = _load_py_file(filename)
    text = open(filename).read()
    base_files = cfg_dict.pop(BASE_KEY, None)
    if base_files is None:
        return cfg_dict, text
    if isinstance(base_files, str):
        base_files = [base_files]
    cfg_dir = osp.dirname(filename)
    merged: dict = {}
    texts = []
    for bf in base_files:
        base_dict, base_text = _load_with_bases(osp.join(cfg_dir, bf))
        dup = set(merged) & set(base_dict)
        if dup:
            raise KeyError(f'Duplicate keys {dup} between base files of {filename}')
        merged.update(base_dict)
        texts.append(base_text)
    merged = _merge_a_into_b(cfg_dict, merged)
    texts.append(text)
    return merged, '\n'.join(texts)


def _strip_delete(obj):
    """Drop leftover ``_delete_`` markers after all merging is done (they
    only have meaning relative to a base; a marker in the root base file has
    nothing to delete)."""
    if isinstance(obj, dict):
        return {k: _strip_delete(v) for k, v in obj.items()
                if k != DELETE_KEY}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_strip_delete(v) for v in obj)
    return obj


class Config:
    """Config object wrapping a ConfigDict, loadable from python files."""

    @staticmethod
    def fromfile(filename: str) -> 'Config':
        cfg_dict, text = _load_with_bases(filename)
        cfg_dict = _strip_delete(cfg_dict)
        return Config(cfg_dict, filename=filename, text=text)

    def __init__(self, cfg_dict=None, filename=None, text=None):
        cfg_dict = cfg_dict or {}
        for k in RESERVED_KEYS:
            if k in cfg_dict:
                raise KeyError(f'{k} is reserved for Config')
        super().__setattr__('_cfg_dict', _to_config_dict(cfg_dict))
        super().__setattr__('_filename', filename)
        super().__setattr__('_text', text)

    @property
    def filename(self):
        return self._filename

    @property
    def text(self):
        return self._text

    def __getattr__(self, name):
        return getattr(self._cfg_dict, name)

    def __setattr__(self, name, value):
        self._cfg_dict[name] = _to_config_dict(value)

    def __getitem__(self, name):
        return self._cfg_dict[name]

    def __setitem__(self, name, value):
        self._cfg_dict[name] = _to_config_dict(value)

    def __contains__(self, name):
        return name in self._cfg_dict

    def __iter__(self):
        return iter(self._cfg_dict)

    def get(self, name, default=None):
        return self._cfg_dict.get(name, default)

    def keys(self):
        return self._cfg_dict.keys()

    def items(self):
        return self._cfg_dict.items()

    def todict(self):
        def _plain(obj):
            if isinstance(obj, dict):
                return {k: _plain(v) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                return type(obj)(_plain(v) for v in obj)
            return obj
        return _plain(self._cfg_dict)

    def merge_from_dict(self, options: dict):
        """Merge dotted-key overrides, e.g. ``{'model.backbone.depth': 101}``
        (ref CLI ``--options``, tools/train.py:69-70)."""
        nested: dict = {}
        for full_key, v in options.items():
            d = nested
            parts = full_key.split('.')
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = v
        merged = _merge_a_into_b(nested, self._cfg_dict)
        super().__setattr__('_cfg_dict', _to_config_dict(merged))

    def dump(self, file: str | None = None) -> str:
        """The config as a Python file of ``name = value`` lines, which
        :meth:`fromfile` loads back (as mmcv's ``Config.dump`` writes it):
        the work dir's copy of a training config serves the ``test`` CLI."""
        import pprint
        s = ''.join(f'{k} = {pprint.pformat(v, width=100, sort_dicts=False)}'
                    '\n' for k, v in self.todict().items())
        if file is not None:
            os.makedirs(osp.dirname(osp.abspath(file)), exist_ok=True)
            with open(file, 'w') as f:
                f.write(s)
        return s

    def __repr__(self):
        return f'Config (path: {self._filename}): {self._cfg_dict!r}'
