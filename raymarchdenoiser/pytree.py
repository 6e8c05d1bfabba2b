"""Frozen dataclasses that are JAX pytrees (every field is a data leaf).

Replaces ``flax.struct.dataclass`` so the package needs nothing beyond JAX:
``@pytree.dataclass`` makes a frozen dataclass, registers it with
``jax.tree_util.register_dataclass`` and gives it ``.replace(**fields)``.
"""

from __future__ import annotations

import dataclasses

import jax


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = _replace
    return jax.tree_util.register_dataclass(cls)
