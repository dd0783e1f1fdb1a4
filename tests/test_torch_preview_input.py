"""The cv2 preview of the PyTorch port: its key sources (io/x11keys.py's
X11Keymap and AutoReleaseKeys, scene._poll_input) with one case for each
case of tests/test_preview_input.py, the mouse callback against the JAX
package's, and the realtime loop through OpenCV's window when SDL cannot
open one, or when SHADERFLOW_PREVIEW=cv2 asks for it. No real cv2 window
opens: a stub module stands in for cv2 (a Qt build of OpenCV can abort a
process without a display)."""

import sys
import types

import numpy as np
import pytest
from test_torch_scene import _fix_reference_texture

from shaderflow_tpu_torch.io.x11keys import AutoReleaseKeys, X11Keymap
from shaderflow_tpu_torch.keyboard import ShaderKeyboard
from shaderflow_tpu_torch.message import ShaderMessage
from shaderflow_tpu_torch.scene import ShaderScene, WindowBackend

Keys = ShaderKeyboard.Keys
NOKEY = 255  # cv2.waitKey(1) & 0xFF with an empty queue


def make_scene():
    scene = ShaderScene()
    scene._setup_run(width=16, height=8, fps=10, time=0.1, freewheel=True, device="cpu")
    return scene


def test_waitkey_fallback_press_hold_release():
    scene = make_scene()
    received = []
    original = scene.relay
    scene.relay = lambda message: (received.append(message), original(message))
    scene._poll_input(ord("w"), now=0.0)
    assert scene.keyboard(Keys.W)
    downs = [m.key for m in received if isinstance(m, ShaderMessage.Keyboard.KeyDown)]
    assert downs == [Keys.W]
    scene._poll_input(ord("w"), now=0.1)
    scene._poll_input(ord("w"), now=0.2)
    downs = [m.key for m in received if isinstance(m, ShaderMessage.Keyboard.KeyDown)]
    assert downs == [Keys.W] and scene.keyboard(Keys.W)
    scene._poll_input(NOKEY, now=1.0)
    ups = [m.key for m in received if isinstance(m, ShaderMessage.Keyboard.KeyUp)]
    assert ups == [Keys.W] and not scene.keyboard(Keys.W)


def test_waitkey_escape_quits():
    scene = make_scene()
    scene._poll_input(27, now=0.0)
    assert scene.quit


class FakeKeymap:
    active = True

    def __init__(self, frames):
        self.frames = list(frames)

    def poll(self):
        return self.frames.pop(0)


def test_x11_keymap_path_delivers_transitions_and_modifiers():
    scene = make_scene()
    scene._keymap = FakeKeymap([([Keys.W, Keys.LEFT_SHIFT], []), ([], [Keys.W]),
                                ([], [Keys.LEFT_SHIFT])])
    scene._poll_input(NOKEY)
    assert scene.keyboard(Keys.W) and scene.keyboard(Keys.LEFT_SHIFT)
    scene._poll_input(NOKEY)
    assert not scene.keyboard(Keys.W) and scene.keyboard(Keys.LEFT_SHIFT)
    scene._poll_input(NOKEY)
    assert not scene.keyboard(Keys.LEFT_SHIFT)


def test_held_keys_drive_camera_until_release():
    scene = make_scene()
    camera = scene.camera
    scene.dt = 1 / 60
    start = np.asarray(camera.position.target).copy()
    scene.relay(ShaderMessage.Keyboard.KeyDown(key=Keys.W))
    camera.update()
    moved = np.asarray(camera.position.target).copy()
    assert np.linalg.norm(moved - start) > 0
    scene.relay(ShaderMessage.Keyboard.KeyUp(key=Keys.W))
    camera.update()
    assert np.allclose(np.asarray(camera.position.target), moved)


def test_shift_modifier_reaches_camera():
    from shaderflow_tpu_torch.camera import CameraMode
    scene = make_scene()
    camera = scene.camera
    camera.mode = CameraMode.FreeCamera
    scene.dt = 1 / 60
    start = np.asarray(camera.position.target).copy()
    scene.relay(ShaderMessage.Keyboard.KeyDown(key=Keys.LEFT_SHIFT))
    camera.update()
    assert np.asarray(camera.position.target)[1] < start[1]


def test_x11_keymap_inactive_without_display(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    keymap = X11Keymap()
    assert not keymap.active
    assert keymap.poll() == ([], [])


def test_autorelease_is_per_key():
    auto = AutoReleaseKeys(linger=0.5)
    assert auto.feed(Keys.W, 0.0)
    assert auto.feed(Keys.A, 0.4)
    assert not auto.feed(Keys.A, 0.45)
    assert auto.poll(0.6) == [Keys.W]
    assert list(auto.held()) == [Keys.A]


def test_keymap_table_matches_jax():
    """The X11 keysym table and the waitKey path relay the same key codes
    as the JAX package's."""
    from shaderflow_tpu.io import x11keys as jax_x11keys
    from shaderflow_tpu_torch.io import x11keys
    assert x11keys._KEYSYM_TO_KEY == jax_x11keys._KEYSYM_TO_KEY


# --------------------------------------------------------------------------- #
# The cv2 window, through a stub module

def stub_cv2(keys=()):
    """A stand-in for cv2's window functions: it records every call, and
    waitKey hands out `keys` (then 255)."""
    calls = []
    codes = list(keys)
    stub = types.SimpleNamespace(
        calls=calls, WINDOW_NORMAL=0, WINDOW_FULLSCREEN=1, WND_PROP_FULLSCREEN=0,
        EVENT_MOUSEMOVE=0, EVENT_LBUTTONDOWN=1, EVENT_RBUTTONDOWN=2, EVENT_MBUTTONDOWN=3,
        EVENT_LBUTTONUP=4, EVENT_RBUTTONUP=5, EVENT_MBUTTONUP=6, EVENT_MOUSEWHEEL=10)
    stub.namedWindow = lambda title, flags=0: calls.append(("namedWindow", title))
    stub.setMouseCallback = lambda title, callback: calls.append(("setMouseCallback", callback))
    stub.imshow = lambda title, frame: calls.append(("imshow", np.array(frame)))
    stub.waitKey = lambda delay=0: (calls.append(("waitKey", delay)),
                                    codes.pop(0) if codes else 255)[1]
    stub.setWindowProperty = lambda *args: calls.append(("setWindowProperty", args))
    stub.destroyAllWindows = lambda: calls.append(("destroyAllWindows",))
    return stub


@pytest.mark.parametrize("how", ["sdl fails", "SHADERFLOW_PREVIEW=cv2"])
def test_cv2_preview_window(monkeypatch, how):
    """With the SDL window refused (or cv2 asked for), the realtime loop
    shows its frames in OpenCV's window: every frame BGR through imshow,
    waitKey codes as keys (W held moves the camera, then its release), the
    mouse callback registered, the window destroyed at the end; the render
    stays on the scene's device."""
    from shaderflow_tpu_torch.io import sdlwindow
    if how == "sdl fails":
        def refuse(*args, **kwargs):
            raise RuntimeError("no video device")
        monkeypatch.setattr(sdlwindow, "SDLWindow", refuse)
        monkeypatch.delenv("SHADERFLOW_PREVIEW", raising=False)
    else:
        monkeypatch.setenv("SHADERFLOW_PREVIEW", "cv2")
    monkeypatch.setenv("SHADERFLOW_SYNC_DISPLAY", "1")
    monkeypatch.delenv("DISPLAY", raising=False)
    stub = stub_cv2(keys=[ord("w")] * 3)
    monkeypatch.setitem(sys.modules, "cv2", stub)
    scene = ShaderScene(backend=WindowBackend.Preview)
    scene.frame_limit = 8
    scene.initialize()
    start = np.asarray(scene.camera.position.target).copy()
    scene.main(width=32, height=16, fps=60, frameskip=False, device="cpu")
    names = [call[0] for call in stub.calls]
    assert names[:2] == ["namedWindow", "setMouseCallback"]
    assert names[-1] == "destroyAllWindows" and scene._preview is None
    shown = [call[1] for call in stub.calls if call[0] == "imshow"]
    assert len(shown) >= 6 and shown[-1].shape == (16, 32, 3)
    assert names.count("waitKey") == len(shown)
    assert np.linalg.norm(np.asarray(scene.camera.position.target) - start) > 0
    assert scene.frame >= 8 and scene.engine.device.type == "cpu"


def cv2_events():
    """A mouse sequence in cv2's callback codes: move, left drag, a wheel,
    a right press and release, a middle press."""
    return [(0, 5, 4, 0), (1, 5, 4, 0), (0, 9, 6, 1), (0, 12, 3, 1), (4, 12, 3, 0),
            (10, 12, 3, 120), (10, 12, 3, -120), (2, 7, 7, 0), (0, 8, 2, 2), (5, 8, 2, 0),
            (3, 2, 2, 0), (6, 2, 2, 0)]


def test_cv2_mouse_event_relays_match_jax(monkeypatch):
    """_cv2_mouse_event relays the same messages, with the same fields, as
    the JAX package's for the same callback sequence."""
    _fix_reference_texture(monkeypatch)
    from shaderflow_tpu.scene import ShaderScene as JaxScene
    logs = []
    for cls, kwargs in ((JaxScene, {}), (ShaderScene, {"device": "cpu"})):
        scene = cls()
        scene._setup_run(width=32, height=16, fps=10, time=0.1, freewheel=True, **kwargs)
        scene._preview = stub_cv2()
        log = []
        relay = scene.relay
        scene.relay = lambda message, relay=relay, log=log: (
            log.append((type(message).__name__, sorted(vars(message).items()))),
            relay(message))[1]
        for event in cv2_events():
            scene._cv2_mouse_event(*event)
        logs.append((log, scene.mouse_gluv, dict(scene.mouse_buttons)))
    assert logs[1] == logs[0]
    assert len(logs[1][0]) == len(cv2_events())
