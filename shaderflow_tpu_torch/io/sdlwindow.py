"""
SDL window of the realtime preview (pygame's bundled SDL2).

Port of shaderflow_tpu/io/sdlwindow.py: a real window with a focused-window
event queue (key press and release with modifiers, unicode text, mouse
move / press / release / wheel, resize, file drop, enter / leave,
minimize, close). Frames are (H, W, 3) uint8 host arrays, blitted scaled
to the window. Events come back as normalized (kind, payload) tuples; the
scene turns them into message relays (it holds the pixel -> uv math and
the modifier intercepts).

Headless runs drive the same code through SDL's dummy video backend
(SHADERFLOW_SDL_VIDEODRIVER=dummy): windows open, frames blit, and
pygame.event.post injects events through the real queue. draw_text is the
HUD's text rasterizer where cv2 is not installed.
"""

from __future__ import annotations

import os

import numpy as np

from shaderflow_tpu_torch.keyboard import _Keys


def _keymap() -> dict:
    """pygame keycode -> shaderflow key table. Right-hand modifiers map to
    the left-hand codes (the scene's intercepts test LEFT_*, like the
    reference's single-modifier checks)."""
    import pygame
    table = {
        pygame.K_SPACE: _Keys.SPACE,
        pygame.K_LEFTBRACKET: _Keys.BRACKET_LEFT,
        pygame.K_RIGHTBRACKET: _Keys.BRACKET_RIGHT,
        pygame.K_COMMA: _Keys.COMMA,
        pygame.K_PERIOD: _Keys.PERIOD,
        pygame.K_MINUS: _Keys.MINUS,
        pygame.K_EQUALS: _Keys.EQUAL,
        pygame.K_PLUS: _Keys.PLUS,
        pygame.K_TAB: _Keys.TAB,
        pygame.K_ESCAPE: _Keys.ESCAPE,
        pygame.K_RETURN: _Keys.ENTER,
        pygame.K_LSHIFT: _Keys.LEFT_SHIFT,
        pygame.K_RSHIFT: _Keys.LEFT_SHIFT,
        pygame.K_LCTRL: _Keys.LEFT_CTRL,
        pygame.K_RCTRL: _Keys.LEFT_CTRL,
        pygame.K_LALT: _Keys.LEFT_ALT,
        pygame.K_RALT: _Keys.LEFT_ALT,
    }
    for i in range(26):
        table[pygame.K_a + i] = ord("A") + i
    for i in range(10):
        table[pygame.K_0 + i] = ord("0") + i
    for i in range(12):
        table[getattr(pygame, f"K_F{i + 1}")] = _Keys.F1 + i
    return table


# pygame buttons: 1 left, 2 middle, 3 right -> scene codes 1 left, 2 right,
# 3 middle (the convention the cv2 handler and camera modes already use)
_BUTTONS = {1: 1, 3: 2, 2: 3}


class SDLWindow:
    """One resizable preview window over pygame/SDL2."""

    def __init__(self, title: str, width: int, height: int):
        video = os.environ.get("SHADERFLOW_SDL_VIDEODRIVER")
        if video:
            os.environ["SDL_VIDEODRIVER"] = video
        import pygame
        self._pygame = pygame
        pygame.display.init()
        pygame.display.set_caption(title)
        self._surface = pygame.display.set_mode((int(width), int(height)),
                                                pygame.RESIZABLE)
        pygame.key.set_repeat()  # disable autorepeat: we get real KeyUp
        self._keys = _keymap()
        self._fullscreen = False

    @property
    def size(self) -> tuple[int, int]:
        return self._surface.get_size()

    def show(self, frame: np.ndarray) -> None:
        """Blit an (H, W, 3) uint8 RGB frame, scaled to the window size."""
        pygame = self._pygame
        surf = pygame.surfarray.make_surface(
            np.ascontiguousarray(frame.swapaxes(0, 1)))
        if surf.get_size() != self._surface.get_size():
            surf = pygame.transform.smoothscale(surf, self._surface.get_size())
        self._surface.blit(surf, (0, 0))
        pygame.display.flip()

    def poll(self) -> list[tuple]:
        """Drain the event queue -> normalized (kind, payload) tuples:

        ("keydown"|"keyup", key:int) · ("unicode", char) ·
        ("mousemove", x, y, dx, dy, buttons:set) ·
        ("mousedown"|"mouseup", button, x, y) · ("wheel", dy:int) ·
        ("resize", w, h) · ("drop", path) · ("enter", bool) · ("close",)
        """
        pygame = self._pygame
        out: list[tuple] = []
        for event in pygame.event.get():
            if event.type == pygame.QUIT:
                out.append(("close",))
            elif event.type == pygame.KEYDOWN:
                key = self._keys.get(event.key)
                if key is not None:
                    out.append(("keydown", key))
                if getattr(event, "unicode", "") and event.unicode.isprintable():
                    out.append(("unicode", event.unicode))
            elif event.type == pygame.KEYUP:
                key = self._keys.get(event.key)
                if key is not None:
                    out.append(("keyup", key))
            elif event.type == pygame.MOUSEMOTION:
                held = {_BUTTONS[i + 1] for i, down in enumerate(event.buttons)
                        if down and (i + 1) in _BUTTONS}
                out.append(("mousemove", *event.pos, *event.rel, held))
            elif event.type == pygame.MOUSEBUTTONDOWN:
                button = _BUTTONS.get(event.button)
                if button is not None:
                    out.append(("mousedown", button, *event.pos))
                # Buttons 4/5 (SDL1-style wheel clicks) are IGNORED: pygame 2
                # posts them as compatibility duplicates of every MOUSEWHEEL
                # event — translating both would double every wheel tick
            elif event.type == pygame.MOUSEBUTTONUP:
                button = _BUTTONS.get(event.button)
                if button is not None:
                    out.append(("mouseup", button, *event.pos))
            elif event.type == pygame.MOUSEWHEEL:
                if event.y:
                    out.append(("wheel", int(np.sign(event.y))))
            elif event.type == pygame.VIDEORESIZE:
                out.append(("resize", event.w, event.h))
            elif event.type == pygame.DROPFILE:
                out.append(("drop", event.file))
            elif event.type == pygame.WINDOWENTER:
                out.append(("enter", True))
            elif event.type == pygame.WINDOWLEAVE:
                out.append(("enter", False))
            elif event.type == getattr(pygame, "WINDOWMINIMIZED", -1):
                out.append(("iconify", True))
            elif event.type == getattr(pygame, "WINDOWRESTORED", -2):
                out.append(("iconify", False))
        return out

    _font = None

    @classmethod
    def draw_text(cls, frame: np.ndarray, lines: list[str],
                  origin: tuple[int, int] = (8, 6), pitch: int = 16) -> np.ndarray:
        """Rasterize HUD text onto an (H, W, 3) uint8 frame with
        pygame.font, the rows at the cv2 path's geometry (the HUD's hit map
        holds for both)."""
        import pygame
        if cls._font is None:
            pygame.font.init()
            cls._font = pygame.font.Font(None, 15)
        x0, y0 = origin
        h, w = frame.shape[:2]
        for index, text in enumerate(lines):
            surf = cls._font.render(text, True, (255, 255, 255), (0, 0, 0))
            glyph = pygame.surfarray.array3d(surf).swapaxes(0, 1)
            y = y0 + pitch * index + 2
            gh = min(glyph.shape[0], h - y)
            gw = min(glyph.shape[1], w - x0)
            if gh <= 0 or gw <= 0:
                continue
            region = frame[y:y + gh, x0:x0 + gw]
            mask = glyph[:gh, :gw].max(axis=-1, keepdims=True) > 32
            np.copyto(region, glyph[:gh, :gw], where=np.broadcast_to(mask, region.shape))
        return frame

    def set_exclusive(self, state: bool) -> None:
        """Exclusive mouse mode (the F1 key): grab the cursor inside the
        window and hide it, so free-look drags never hit the window edge."""
        pygame = self._pygame
        try:
            pygame.event.set_grab(bool(state))
            pygame.mouse.set_visible(not state)
        except Exception:
            pass  # the dummy video backend has no cursor

    def set_fullscreen(self, state: bool) -> None:
        if state == self._fullscreen:
            return
        self._fullscreen = state
        try:
            self._pygame.display.toggle_fullscreen()
        except Exception:
            pass  # the dummy video backend, a WM without fullscreen

    def close(self) -> None:
        self._pygame.display.quit()
