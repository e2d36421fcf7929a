"""Frozen dataclasses that JAX treats as pytrees of their fields."""

from __future__ import annotations

import dataclasses

import jax


def pytree_dataclass(cls):
    """Frozen dataclass registered as a pytree whose leaves are all its
    fields, with `replace(**changes)` for functional updates."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    jax.tree_util.register_dataclass(
        cls, data_fields=[f.name for f in dataclasses.fields(cls)],
        meta_fields=[])
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return cls
