"""
Typed message bus vocabulary: the messages the port's modules relay and
handle (the reference's namespaced taxonomy, shaderflow_tpu/message.py).
Messages are plain dataclasses; they drive host-side state (recompiles,
texture re-makes, interaction) and never touch the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


class ShaderMessage:

    class Custom:
        data: Any

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
        class Press:
            button: int = 0
            x: int = 0
            y: int = 0
            u: float = 0.0
            v: float = 0.0

        @dataclass
        class Release:
            button: int = 0
            x: int = 0
            y: int = 0
            u: float = 0.0
            v: float = 0.0

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

        @dataclass
        class Enter:
            state: bool = True

    class Window:

        @dataclass
        class Resize:
            width: Optional[int] = None
            height: Optional[int] = None

            @property
            def size(self) -> tuple[Optional[int], Optional[int]]:
                return (self.width, self.height)

        @dataclass
        class Iconify:
            state: Optional[bool] = None

        @dataclass
        class FileDrop:
            files: list[str] = field(default_factory=list)

            def get(self, index: int) -> Optional[str]:
                return self.files[index] if index < len(self.files) else None

            @property
            def first(self) -> Optional[str]:
                return self.get(0)

            @property
            def second(self) -> Optional[str]:
                return self.get(1)

            @property
            def third(self) -> Optional[str]:
                return self.get(2)

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

        @dataclass
        class Render:
            pass

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

        @dataclass
        class Unicode:
            char: Optional[str] = None
