"""
Typed message bus vocabulary: the messages the port's modules relay and
handle (the reference's namespaced taxonomy, shaderflow_tpu/message.py).
Messages are plain dataclasses; they drive host-side state (recompiles,
texture re-makes, interaction) and never touch the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


class ShaderMessage:

    class Mouse:

        @dataclass
        class Position:
            x: int = 0
            y: int = 0
            dx: int = 0
            dy: int = 0
            u: float = 0.0
            v: float = 0.0
            du: float = 0.0
            dv: float = 0.0

        @dataclass
        class Drag:
            x: int = 0
            y: int = 0
            dx: int = 0
            dy: int = 0
            u: float = 0.0
            v: float = 0.0
            du: float = 0.0
            dv: float = 0.0

        @dataclass
        class Scroll:
            dx: int = 0
            dy: int = 0
            du: float = 0.0
            dv: float = 0.0

    class Window:

        @dataclass
        class FileDrop:
            files: list[str] = field(default_factory=list)

            @property
            def first(self) -> Optional[str]:
                return self.files[0] if self.files else None

        @dataclass
        class Close:
            pass

    class Shader:

        @dataclass
        class RecreateTextures:
            """Resolution/SSAA/dtype changed: texture storage must be
            rebuilt and the render engine re-specialized."""

        @dataclass
        class Compile:
            """(Re)build the pixel programs."""

    class Keyboard:

        @dataclass
        class Press:
            key: Optional[int] = None
            action: Optional[int] = None
            modifiers: Optional[int] = None

        @dataclass
        class KeyDown:
            key: Optional[int] = None
            modifiers: Optional[int] = None

        @dataclass
        class KeyUp:
            key: Optional[int] = None
            modifiers: Optional[int] = None
