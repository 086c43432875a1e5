"""Name -> class registry (counterpart of ``sprc_tpu/registry.py``).

A plain mapping from (kind, name) to classes and factories, so that run
configs and CLIs resolve models, image / text processors, dataset builders
and tasks by name. The kinds are those of the JAX registry that the port
fills: ``model``, ``processor``, ``dataset``, ``task``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List


class Registry:
    KINDS = ("model", "processor", "dataset", "task")

    def __init__(self) -> None:
        self._maps: Dict[str, Dict[str, Any]] = {k: {} for k in self.KINDS}

    def register(self, kind: str, name: str, *, override: bool = False) -> Callable[[Any], Any]:
        """Decorator: ``@registry.register("dataset", "coco_retrieval")``."""
        if kind not in self._maps:
            raise KeyError(f"unknown registry kind '{kind}' (have {list(self._maps)})")

        def deco(obj: Any) -> Any:
            table = self._maps[kind]
            if name in table and not override and table[name] is not obj:
                raise KeyError(f"{kind} '{name}' already registered to {table[name]!r}")
            table[name] = obj
            return obj

        return deco

    def register_model(self, name: str, **kw: Any) -> Callable[[Any], Any]:
        return self.register("model", name, **kw)

    def register_processor(self, name: str, **kw: Any) -> Callable[[Any], Any]:
        return self.register("processor", name, **kw)

    def get(self, kind: str, name: str) -> Any:
        try:
            return self._maps[kind][name]
        except KeyError:
            raise KeyError(f"no {kind} named '{name}'; registered: "
                           f"{sorted(self._maps[kind])}") from None

    def get_model_class(self, name: str) -> Any:
        return self.get("model", name)

    def get_processor_class(self, name: str) -> Any:
        return self.get("processor", name)

    def list(self, kind: str) -> List[str]:
        return sorted(self._maps[kind])


registry = Registry()
