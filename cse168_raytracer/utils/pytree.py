"""Frozen dataclasses registered as JAX pytrees, with a `.replace`.

Fields are pytree children unless declared with `static_field()`, which
puts them in the treedef (hashable jit specialization keys)."""

from __future__ import annotations

import dataclasses

import jax


def static_field(default=dataclasses.MISSING):
    return dataclasses.field(default=default, metadata={"static": True})


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields
                     if not f.metadata.get("static", False)],
        meta_fields=[f.name for f in fields
                     if f.metadata.get("static", False)])
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return cls
