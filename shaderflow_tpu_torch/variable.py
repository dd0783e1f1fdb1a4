"""
Shader variable metamodel — the typed currency of the uniform pipeline
(shaderflow_tpu/variable.py): modules yield `Uniform(type, name, value)`
from pipeline(); the engine packs those values per frame batch. GLSL type
names document arity and drive value coercion.
"""

from __future__ import annotations

from typing import Any

import numpy as np

# GLSL type -> (numpy dtype, component count)
TYPE_INFO: dict[str, tuple[np.dtype, int]] = {
    "float": (np.dtype(np.float32), 1),
    "int": (np.dtype(np.int32), 1),
    "bool": (np.dtype(np.int32), 1),
    "vec2": (np.dtype(np.float32), 2),
    "vec3": (np.dtype(np.float32), 3),
    "vec4": (np.dtype(np.float32), 4),
    "mat2": (np.dtype(np.float32), 4),
    "mat3": (np.dtype(np.float32), 9),
    "mat4": (np.dtype(np.float32), 16),
}


class ShaderVariable:
    """A named, typed value flowing through the pipeline. Equality and
    hashing are by name. Static values specialize the render (camera
    projection enums, texture layer counts): the engine reads them at build
    time instead of packing them per frame."""

    __slots__ = ("type", "name", "value", "qualifier", "static")

    def __init__(self, type: str, name: str, value: Any = None,
                 qualifier: str = None, static: bool = False):
        self.type = type
        self.name = name
        self.value = value
        self.qualifier = qualifier
        self.static = static

    def __hash__(self) -> int:
        return hash(self.name)

    def __eq__(self, other) -> bool:
        return isinstance(other, ShaderVariable) and self.name == other.name

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.type} {self.name} = {self.value!r})"

    def coerce(self) -> np.ndarray:
        """Convert .value to the canonical numpy array for batching."""
        kind = self.type
        value = self.value
        # Fast paths for the common scalar uniforms (the pipeline sweep runs
        # per frame on the host)
        if kind == "float":
            try:
                return np.float32(value)
            except TypeError:
                pass
        elif kind == "int":
            try:
                return np.int32(value)
            except TypeError:
                pass
        elif kind == "bool":
            return np.int32(bool(value))

        info = TYPE_INFO.get(kind)
        if info is None:
            raise TypeError(f"Cannot batch variable of type {kind!r} ({self.name})")
        dtype, count = info
        array = np.asarray(value, dtype=dtype).reshape(-1)
        if array.size == 1 and count > 1:
            array = np.repeat(array, count)
        if array.size != count:
            raise ValueError(
                f"Variable {self.name}: {kind} expects {count} components, got {array.size}")
        return array if count > 1 else array.reshape(())


class Uniform(ShaderVariable):
    def __init__(self, type: str, name: str, value: Any = None, **kwargs):
        kwargs.setdefault("qualifier", "uniform")
        super().__init__(type, name, value, **kwargs)


class StaticUniform(Uniform):
    """A uniform whose value specializes the render (ShaderVariable.static)."""

    def __init__(self, type: str, name: str, value: Any = None, **kwargs):
        kwargs.setdefault("static", True)
        super().__init__(type, name, value, **kwargs)
