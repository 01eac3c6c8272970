"""Immutable dataclasses that are JAX pytrees."""

from __future__ import annotations

import dataclasses

import jax


def pytree_dataclass(cls):
    """Frozen dataclass registered as a pytree, with a `.replace(**kw)`
    copy method. Fields declared `static_field(...)` are static (pytree
    metadata, part of the jit cache key); every other field is a leaf."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return jax.tree_util.register_dataclass(cls)


def static_field(**kw):
    return dataclasses.field(metadata={"static": True}, **kw)
