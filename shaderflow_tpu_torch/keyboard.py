"""
Keyboard state module — port of shaderflow_tpu/keyboard.py: a pressed-state
dict fed by relayed keyboard messages, with callable sugar
`scene.keyboard(Keys.W)`. The key table is the reference's own;
set_keymap swaps it. With export_keys=True (off by default, as in the
reference) every key of the table is a bool uniform, iKey<Name>.
"""

from __future__ import annotations

from typing import Union

from shaderflow_tpu_torch.message import ShaderMessage
from shaderflow_tpu_torch.module import ShaderModule
from shaderflow_tpu_torch.variable import Uniform


class _Keys:
    """Key code table (stable, window-library-free)."""
    ACTION_PRESS = 1
    ACTION_RELEASE = 0

    A, B, C, D, E, F, G = (ord(c) for c in "ABCDEFG")
    H, I, J, K, L, M, N = (ord(c) for c in "HIJKLMN")
    O, P, Q, R, S, T, U = (ord(c) for c in "OPQRSTU")
    V, W, X, Y, Z = (ord(c) for c in "VWXYZ")
    NUMBER_0, NUMBER_1, NUMBER_2, NUMBER_3, NUMBER_4 = (ord(c) for c in "01234")
    NUMBER_5, NUMBER_6, NUMBER_7, NUMBER_8, NUMBER_9 = (ord(c) for c in "56789")
    SPACE = ord(" ")
    BRACKET_LEFT = ord("[")
    BRACKET_RIGHT = ord("]")
    COMMA = ord(",")
    PERIOD = ord(".")
    MINUS = ord("-")
    EQUAL = ord("=")
    PLUS = ord("+")
    TAB = 9
    ESCAPE = 27
    ENTER = 13
    F1, F2, F3, F4, F5, F6 = range(0x10001, 0x10007)
    F7, F8, F9, F10, F11, F12 = range(0x10007, 0x1000D)
    LEFT_SHIFT = 0x20001
    LEFT_CTRL = 0x20002
    LEFT_ALT = 0x20003


class ShaderKeyboard(ShaderModule):
    Keys = _Keys

    def __init__(self, scene=None, export_keys: bool = False, **kwargs):
        self._pressed: dict[int, bool] = {}
        self.export_keys = bool(export_keys)
        super().__init__(scene=scene, **kwargs)

    def pipeline(self):
        if not self.export_keys:
            return
        for name, code in vars(type(self).Keys).items():
            if (name.startswith("_") or not isinstance(code, int)
                    or name in ("ACTION_PRESS", "ACTION_RELEASE")):
                continue
            yield Uniform("bool", f"iKey{name.title().replace('_', '')}",
                          self._pressed.get(code, False))

    @staticmethod
    def set_keymap(keymap) -> None:
        """Swap the key table (a window library's, say)."""
        ShaderKeyboard.Keys = keymap

    def pressed(self, key: Union[int, None] = None) -> bool:
        return self._pressed.setdefault(key, False)

    def __call__(self, *args, **kwargs) -> bool:
        return self.pressed(*args, **kwargs)

    def handle(self, message) -> None:
        if isinstance(message, ShaderMessage.Keyboard.Press):
            self._pressed[message.key] = (message.action != self.Keys.ACTION_RELEASE)
        elif isinstance(message, ShaderMessage.Keyboard.KeyDown):
            self._pressed[message.key] = True
        elif isinstance(message, ShaderMessage.Keyboard.KeyUp):
            self._pressed[message.key] = False
