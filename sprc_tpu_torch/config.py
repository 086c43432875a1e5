"""Run configs: YAML run / model / datasets sections with dotlist overrides
(the port's copy of ``sprc_tpu/config.py:20-124``; it has no JAX in it, and
``tests/test_torch_framework.py`` pins the copy equal to the original).

A three-way merge of the run / model / datasets sections plus
``key.path=value`` overrides on plain dicts (the reference's OmegaConf
stack, src/lavis/common/config.py:16-166). PyYAML is imported only where a
file or an override is parsed: ``Config(defaults=<dict>)`` needs none, which
is how ``chip_smoke.py`` drives the CLIs on a machine without it.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List, Optional

CONFIG_ROOT = os.path.join(os.path.dirname(__file__), "..", "configs")


def load_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Recursive dict merge; override wins (OmegaConf.merge semantics for
    the subset we use)."""
    out = copy.deepcopy(base)
    for key, value in override.items():
        if key in out and isinstance(out[key], dict) and isinstance(value, dict):
            out[key] = deep_merge(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


def _parse_scalar(text: str) -> Any:
    import yaml

    # YAML 1.1 rejects exponent floats without a dot ("2e-4"); accept them
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    return yaml.safe_load(text)


def apply_dotlist(cfg: Dict[str, Any], overrides: List[str]) -> Dict[str, Any]:
    """Apply ``a.b.c=value`` overrides (reference config.py:114-126)."""
    out = copy.deepcopy(cfg)
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override '{item}' is not of the form key=value")
        key, _, raw = item.partition("=")
        node = out
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise ValueError(f"cannot override scalar '{part}' in '{key}'")
        node[parts[-1]] = _parse_scalar(raw)
    return out


class Config:
    """run/model/datasets sections merged from YAML + dotlist overrides."""

    def __init__(
        self,
        config_path: Optional[str] = None,
        overrides: Optional[List[str]] = None,
        defaults: Optional[Dict[str, Any]] = None,
    ):
        cfg: Dict[str, Any] = copy.deepcopy(defaults or {})
        if config_path:
            cfg = deep_merge(cfg, load_yaml(config_path))
        if overrides:
            cfg = apply_dotlist(cfg, list(overrides))
        self._cfg = cfg

    @property
    def run(self) -> Dict[str, Any]:
        return self._cfg.get("run", {})

    @property
    def model(self) -> Dict[str, Any]:
        return self._cfg.get("model", {})

    @property
    def datasets(self) -> Dict[str, Any]:
        return self._cfg.get("datasets", {})

    def get(self, key: str, default: Any = None) -> Any:
        node: Any = self._cfg
        for part in key.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._cfg)


def model_config_path(arch: str, model_type: str) -> str:
    """Resolve ``configs/models/<arch>/<model_type>.yaml``."""
    return os.path.normpath(
        os.path.join(CONFIG_ROOT, "models", arch, f"{model_type}.yaml")
    )
