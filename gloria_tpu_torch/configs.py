"""Minimal OmegaConf-compatible configuration (the port's own copy).

Same semantics as ``gloria_tpu.configs.Config``: attribute and item access,
missing keys read as ``None``, the dict protocol.  It reads no files, so the
port needs no PyYAML.  The merge and dotted-path setters wait for the
port's driver, their only user.
"""

from __future__ import annotations

import copy
from typing import Any, Mapping


class Config(dict):
    """A recursive attribute-dict. Missing keys read as ``None``."""

    def __init__(self, data: Mapping[str, Any] | None = None, **kwargs: Any):
        super().__init__()
        merged: dict = dict(data or {})
        merged.update(kwargs)
        for key, value in merged.items():
            self[key] = value

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Config):
            return value
        if isinstance(value, Mapping):
            return Config(value)
        if isinstance(value, (list, tuple)):
            return [Config._wrap(v) for v in value]
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, Config._wrap(value))

    def __getitem__(self, key: str) -> Any:
        return super().get(key, None)

    def __getattr__(self, key: str) -> Any:
        if key.startswith("__") and key.endswith("__"):
            raise AttributeError(key)
        return super().get(key, None)

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        if key in self:
            del self[key]

    def get(self, key: str, default: Any = None) -> Any:
        return super().get(key, default)

    def __deepcopy__(self, memo: dict) -> "Config":
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> dict:
        def unwrap(value: Any) -> Any:
            if isinstance(value, Config):
                return {k: unwrap(v) for k, v in value.items()}
            if isinstance(value, list):
                return [unwrap(v) for v in value]
            return value

        return unwrap(self)
