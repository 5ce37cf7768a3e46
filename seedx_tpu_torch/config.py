"""Object-graph config system (reference: seedx_tpu/config.py).

The reference drives every model / data object from YAML files with a
``_target_`` dotted path, instantiated with ``hydra.utils.instantiate``
(reference: src/train/train_seed_x_sft.py:167-187, configs/**/*.yaml):

  * ``load_config(path)``        -> plain dict from YAML
  * ``instantiate(cfg, **kw)``   -> resolve ``_target_`` recursively and call it
  * ``_recursive_: False``       -> leave child dicts unresolved (lazy configs)
  * ``_partial_: True``          -> return ``functools.partial`` instead of calling

The repo's YAMLs name the JAX package (``seedx_tpu.models.factory.
build_agent``); ``resolve_target`` reads a leading ``seedx_tpu.`` as
``seedx_tpu_torch.`` before anything is imported, so a config resolves to
the port's factory and never imports the JAX package.  A target the port
does not have raises ``ImportError``.
"""

from __future__ import annotations

import functools
import importlib
from typing import Any, Mapping

import yaml

_TARGET = "_target_"
_RECURSIVE = "_recursive_"
_PARTIAL = "_partial_"
_RESERVED = (_TARGET, _RECURSIVE, _PARTIAL)
_JAX_PACKAGE, _PORT = "seedx_tpu.", "seedx_tpu_torch."


def load_config(path: str) -> Any:
    with open(path, "r") as f:
        return yaml.safe_load(f)


def resolve_target(dotted: str) -> Any:
    """Resolve ``pkg.module.attr`` (nested attrs after the module work),
    with ``seedx_tpu.`` read as ``seedx_tpu_torch.``."""
    if dotted.startswith(_JAX_PACKAGE):
        dotted = _PORT + dotted[len(_JAX_PACKAGE):]
    parts = dotted.split(".")
    for split in range(len(parts) - 1, 0, -1):
        module_name = ".".join(parts[:split])
        try:
            obj = importlib.import_module(module_name)
        except ImportError:
            continue
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
            return obj
        except AttributeError:
            continue
    raise ImportError(f"cannot resolve target {dotted!r}")


def instantiate(cfg: Any, /, **overrides: Any) -> Any:
    """Instantiate an object graph described by nested dicts.

    Any mapping containing ``_target_`` is turned into a call of the resolved
    target with its remaining keys as kwargs (themselves instantiated
    recursively unless ``_recursive_: False``).  ``overrides`` are merged into
    the top-level call, matching hydra's runtime-kwarg injection.
    """
    if isinstance(cfg, Mapping) and _TARGET in cfg:
        recursive = cfg.get(_RECURSIVE, True)
        partial = cfg.get(_PARTIAL, False)
        target = resolve_target(cfg[_TARGET])
        kwargs = {}
        for key, value in cfg.items():
            if key in _RESERVED:
                continue
            kwargs[key] = instantiate(value) if recursive else value
        kwargs.update(overrides)
        if partial:
            return functools.partial(target, **kwargs)
        return target(**kwargs)
    if isinstance(cfg, Mapping):
        out = {k: instantiate(v) for k, v in cfg.items()}
        out.update(overrides)
        return out
    if isinstance(cfg, (list, tuple)):
        return type(cfg)(instantiate(v) for v in cfg)
    if overrides:
        raise ValueError("overrides passed for a non-mapping config")
    return cfg


def instantiate_from_file(path: str, /, **overrides: Any) -> Any:
    return instantiate(load_config(path), **overrides)
