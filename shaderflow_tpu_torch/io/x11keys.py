"""
X11 keyboard-state poller for the cv2 preview.

Port of shaderflow_tpu/io/x11keys.py. cv2's waitKey delivers autorepeat
key-down codes only: no release and no modifier state, so held-key
navigation (the camera's WASD with Shift / Ctrl) cannot run from it alone.
X11 gives the whole keyboard bitmap through XQueryKeymap (256 bits, one a
keycode) without owning the event loop: the preview polls it once a frame
and diffs it against the last one, relaying exact Keyboard.KeyDown /
Keyboard.KeyUp messages for every transition, Shift, Ctrl and Alt
included. ctypes on libX11; inactive (poll() returns empty pairs) without
a display or the library. AutoReleaseKeys is the waitKey fallback: it
synthesizes a release when a key's autorepeat train goes quiet.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterable, Optional

# X11 keysyms (X11/keysymdef.h) -> shaderflow key codes
from shaderflow_tpu_torch.keyboard import _Keys

_KEYSYM_TO_KEY = {
    0xFFE1: _Keys.LEFT_SHIFT, 0xFFE3: _Keys.LEFT_CTRL, 0xFFE9: _Keys.LEFT_ALT,
    0xFF1B: _Keys.ESCAPE, 0xFF0D: _Keys.ENTER, 0xFF09: _Keys.TAB,
    0x0020: _Keys.SPACE, 0x005B: _Keys.BRACKET_LEFT, 0x005D: _Keys.BRACKET_RIGHT,
    0x002C: _Keys.COMMA, 0x002E: _Keys.PERIOD,
    0x002D: _Keys.MINUS, 0x003D: _Keys.EQUAL, 0x002B: _Keys.PLUS,
}
for _index in range(12):  # XK_F1 = 0xFFBE
    _KEYSYM_TO_KEY[0xFFBE + _index] = _Keys.F1 + _index
for _letter in range(26):  # lowercase latin keysyms == ASCII
    _KEYSYM_TO_KEY[ord("a") + _letter] = ord("A") + _letter
for _digit in range(10):
    _KEYSYM_TO_KEY[ord("0") + _digit] = ord("0") + _digit


class X11Keymap:
    """Polls the X server's 256-bit key-state map and yields transitions.

    Usage per frame::

        downs, ups = keymap.poll()
        for key in downs: relay(Keyboard.KeyDown(key=key))
        for key in ups:   relay(Keyboard.KeyUp(key=key))
    """

    def __init__(self, display: Optional[str] = None):
        self._dpy = None
        self._lib = None
        self._last: set[int] = set()
        if not (display or os.environ.get("DISPLAY")):
            return
        try:
            lib = ctypes.CDLL("libX11.so.6")
        except OSError:
            return
        lib.XOpenDisplay.restype = ctypes.c_void_p
        lib.XOpenDisplay.argtypes = [ctypes.c_char_p]
        lib.XQueryKeymap.argtypes = [ctypes.c_void_p, ctypes.c_char * 32]
        lib.XKeycodeToKeysym.restype = ctypes.c_ulong
        lib.XKeycodeToKeysym.argtypes = [ctypes.c_void_p, ctypes.c_ubyte,
                                         ctypes.c_int]
        lib.XGetInputFocus.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_ulong),
                                       ctypes.POINTER(ctypes.c_int)]
        lib.XInternAtom.restype = ctypes.c_ulong
        lib.XInternAtom.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int]
        lib.XGetWindowProperty.restype = ctypes.c_int
        lib.XGetWindowProperty.argtypes = [
            ctypes.c_void_p, ctypes.c_ulong, ctypes.c_ulong, ctypes.c_long,
            ctypes.c_long, ctypes.c_int, ctypes.c_ulong,
            ctypes.POINTER(ctypes.c_ulong), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_ulong), ctypes.POINTER(ctypes.c_ulong),
            ctypes.POINTER(ctypes.c_void_p)]
        lib.XQueryTree.restype = ctypes.c_int
        lib.XQueryTree.argtypes = [
            ctypes.c_void_p, ctypes.c_ulong, ctypes.POINTER(ctypes.c_ulong),
            ctypes.POINTER(ctypes.c_ulong), ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_uint)]
        lib.XFree.argtypes = [ctypes.c_void_p]
        # X protocol errors (e.g. BadWindow when the focused FOREIGN window
        # is destroyed between XGetInputFocus and our property/tree queries)
        # reach Xlib's default handler, which prints and calls exit() —
        # killing the whole preview. Install a no-op handler; every call
        # below treats failure as "unknown", which fails open.
        handler_type = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_void_p)
        self._x_error_handler = handler_type(lambda _dpy, _event: 0)
        lib.XSetErrorHandler.restype = ctypes.c_void_p
        lib.XSetErrorHandler.argtypes = [handler_type]
        lib.XSetErrorHandler(self._x_error_handler)

        dpy = lib.XOpenDisplay(display.encode() if display else None)
        if not dpy:
            return
        self._lib, self._dpy = lib, dpy
        # keycode -> our key code, resolved once (layout churn mid-run is
        # not worth a per-frame XKeycodeToKeysym round)
        self._keycode_map: dict[int, int] = {}
        for keycode in range(8, 256):
            keysym = lib.XKeycodeToKeysym(dpy, keycode, 0)
            key = _KEYSYM_TO_KEY.get(int(keysym))
            if key is not None:
                self._keycode_map[keycode] = key

    @property
    def active(self) -> bool:
        return self._dpy is not None

    def _window_pid(self, window: int) -> Optional[int]:
        """_NET_WM_PID of an X window, or None when the property is absent."""
        atom = self._lib.XInternAtom(self._dpy, b"_NET_WM_PID", 1)
        if not atom:
            return None
        actual_type = ctypes.c_ulong()
        actual_format = ctypes.c_int()
        nitems = ctypes.c_ulong()
        remaining = ctypes.c_ulong()
        prop = ctypes.c_void_p()
        status = self._lib.XGetWindowProperty(
            self._dpy, window, atom, 0, 1, 0, 6,  # XA_CARDINAL = 6
            ctypes.byref(actual_type), ctypes.byref(actual_format),
            ctypes.byref(nitems), ctypes.byref(remaining), ctypes.byref(prop))
        if status != 0 or not prop.value:
            return None
        try:
            if nitems.value < 1:
                return None  # Xlib still allocated a buffer: freed below
            return int(ctypes.cast(prop, ctypes.POINTER(ctypes.c_ulong))[0])
        finally:
            self._lib.XFree(prop)

    def focused(self) -> bool:
        """True unless the input focus POSITIVELY belongs to another process.

        XQueryKeymap reads the global keyboard state regardless of which
        window has focus, so without this gate keys typed into any other
        application while the preview runs would be relayed to the scene —
        including ESC, which quits it (the reference only ever receives
        focused glfw window events). Resolution: walk the focused window's
        ancestry for _NET_WM_PID and compare against our pid. Fail OPEN
        (True) when focus is PointerRoot/None or no PID is advertised —
        WM-less servers (Xvfb CI) never set focus or the property."""
        if self._dpy is None:
            return False
        window = ctypes.c_ulong()
        revert = ctypes.c_int()
        self._lib.XGetInputFocus(self._dpy, ctypes.byref(window),
                                 ctypes.byref(revert))
        current = int(window.value)
        if current in (0, 1):  # None / PointerRoot: no WM focus model
            return True
        for _ in range(32):  # ancestry walk; focus often sits on a child
            pid = self._window_pid(current)
            if pid is not None:
                return pid == os.getpid()
            root = ctypes.c_ulong()
            parent = ctypes.c_ulong()
            children = ctypes.c_void_p()
            count = ctypes.c_uint()
            if not self._lib.XQueryTree(self._dpy, current, ctypes.byref(root),
                                        ctypes.byref(parent),
                                        ctypes.byref(children),
                                        ctypes.byref(count)):
                return True
            if children.value:
                self._lib.XFree(children)
            if int(parent.value) in (0, int(root.value)) or int(parent.value) == current:
                return True  # reached the root without a PID: unknown owner
            current = int(parent.value)
        return True

    def poll(self) -> tuple[list[int], list[int]]:
        """Returns (pressed-since-last-poll, released-since-last-poll).

        When input focus belongs to another process, the keymap reads as
        all-released: held keys get their KeyUp on focus loss and no foreign
        keystrokes are relayed (glfw focus semantics)."""
        if self._dpy is None:
            return [], []
        if not self.focused():
            ups = sorted(self._last)
            self._last = set()
            return [], ups
        bitmap = (ctypes.c_char * 32)()
        self._lib.XQueryKeymap(self._dpy, bitmap)
        held: set[int] = set()
        raw = bytes(bitmap)
        for byte_index, byte in enumerate(raw):
            while byte:
                bit = byte & -byte
                keycode = byte_index * 8 + bit.bit_length() - 1
                byte ^= bit
                key = self._keycode_map.get(keycode)
                if key is not None:
                    held.add(key)
        downs = sorted(held - self._last)
        ups = sorted(self._last - held)
        self._last = held
        return downs, ups

    def close(self) -> None:
        if self._dpy is not None:
            self._lib.XCloseDisplay(self._dpy)
            self._dpy = None


class AutoReleaseKeys:
    """Fallback transition source for bare cv2.waitKey feeds (no X server):
    synthesizes KeyUp when a key's autorepeat stream goes quiet.

    waitKey expresses only "some key code arrived" — holding a key yields a
    repeat train (OS autorepeat, typically 30-60 ms period once started).
    feed() marks the key held; poll(now) releases any key not re-fed within
    `linger` seconds. Holding therefore works (repeats keep it alive), and
    release lands within ~linger of the physical release — lossy but honest
    about it; modifier keys never arrive at all on this path (documented
    limitation; the X11 poller above is the full-fidelity source).
    """

    def __init__(self, linger: float = 0.50):
        self.linger = float(linger)
        self._held: dict[int, float] = {}

    def feed(self, key: int, now: float) -> bool:
        """Record a key-down event; returns True if newly pressed."""
        fresh = key not in self._held
        self._held[key] = now
        return fresh

    def poll(self, now: float) -> list[int]:
        """Keys whose repeat train expired -> synthesized releases."""
        released = [key for key, seen in self._held.items()
                    if now - seen > self.linger]
        for key in released:
            del self._held[key]
        return released

    def held(self) -> Iterable[int]:
        return self._held.keys()
