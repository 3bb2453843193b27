"""Registries for models / datasets / losses / optimizers.

The reference has no registry — every project hard-imports its own
``models/`` dir (SURVEY.md §1). One registry per category lets the shared
trainer build anything from a config string, which is what makes a single
harness serve the whole zoo.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._entries: Dict[str, Callable[..., Any]] = {}

    def register(self, name: Optional[str] = None) -> Callable:
        def deco(fn: Callable) -> Callable:
            key = name or fn.__name__
            if key in self._entries:
                raise KeyError(f"{key!r} already registered in {self._name}")
            self._entries[key] = fn
            return fn
        return deco

    def get(self, name: str) -> Callable[..., Any]:
        if name not in self._entries:
            raise KeyError(
                f"{name!r} not found in registry {self._name!r}. "
                f"Available: {sorted(self._entries)}")
        return self._entries[name]

    def build(self, name: str, *args: Any, **kwargs: Any) -> Any:
        return self.get(name)(*args, **kwargs)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._entries))

    def keys(self):
        return sorted(self._entries)


MODELS = Registry("models")
DATASETS = Registry("datasets")
LOSSES = Registry("losses")
OPTIMIZERS = Registry("optimizers")
SCHEDULES = Registry("schedules")
