"""The realtime preview's display side in the PyTorch port: the display
pump (shaderflow_tpu_torch/io/displaypump.py) on torch tensors, the cases
of tests/test_display_pump.py (latest wins, never blocks, slow transfers
drop frames, close, the decimation choice); the SDL window
(shaderflow_tpu_torch/io/sdlwindow.py) under SDL's dummy video backend,
whose posted events must come back as the JAX package's window returns
them and drive the same relayed messages and scene state through
_dispatch_window_events; and the windowed realtime loop (asynchronous
display through the pump, synchronous display, a forced micro-batch)."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from shaderflow_tpu_torch.io.displaypump import DisplayPump


def _wait_take(pump, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = pump.take()
        if got is not None:
            return got
        time.sleep(0.001)
    return None


def test_pump_transfers_latest_and_never_blocks():
    pump = DisplayPump()
    try:
        a = torch.full((1, 4, 4, 3), 1, dtype=torch.uint8)
        b = torch.full((1, 4, 4, 3), 2, dtype=torch.uint8)
        pump.offer(a, tag=10)
        got = _wait_take(pump)
        assert got is not None and got[0, 0, 0] == 1 and pump.shown_tag == 10
        started = time.perf_counter()
        assert pump.take() is None
        assert time.perf_counter() - started < 0.1
        pump.offer(a, tag=11)
        pump.offer(b, tag=12)
        seen = []
        deadline = time.time() + 5.0
        while time.time() < deadline and (not seen or seen[-1] != 2):
            got = pump.take()
            if got is not None:
                seen.append(int(got[0, 0, 0]))
            time.sleep(0.001)
        assert seen[-1] == 2 and pump.shown_tag == 12
        assert pump.offered == 3 and pump.transferred + pump.dropped == 3
    finally:
        pump.close()


def test_pump_close_is_idempotent_and_fast():
    pump = DisplayPump()
    started = time.perf_counter()
    pump.close()
    pump.close()
    assert time.perf_counter() - started < 5.0


class SlowFrames:
    """A batch of torch frames whose transfer takes `delay` seconds."""

    def __init__(self, value: int, delay: float, log: list):
        self.frames = torch.full((1, 4, 4, 3), value, dtype=torch.uint8)
        self.value, self.delay, self.log = value, delay, log

    def __getitem__(self, index):
        return self

    def __array__(self, dtype=None, copy=None):
        time.sleep(self.delay)
        self.log.append(self.value)
        return self.frames[-1].numpy()


def test_slow_transfers_drop_frames_latest_wins():
    log = []
    pump = DisplayPump()
    try:
        for k in range(10):
            pump.offer(SlowFrames(k, 0.03, log))
            time.sleep(0.005)
        deadline = time.time() + 5.0
        last = None
        while time.time() < deadline and last != 9:
            got = pump.take()
            if got is not None:
                last = int(got[0, 0, 0])
            time.sleep(0.005)
        assert last == 9
        assert len(log) < 10 and pump.dropped == 10 - len(log)
    finally:
        pump.close()


def test_pump_adaptive_decimation_matches_reference():
    """The decimation controller decides as the JAX pump's on the same
    measured transfer times."""
    from shaderflow_tpu.io.displaypump import DisplayPump as ReferencePump
    host = np.zeros((8, 8, 3), np.uint8)
    cases = [(1, 0.600), (1, 2.5), (4, 0.040), (4, 0.0001), (2, 0.151), (8, 0.3), (1, 0.15)]
    for start, seconds in cases:
        pumps = []
        for cls in (ReferencePump, DisplayPump):
            pump = cls.__new__(cls)      # the controller alone, no worker
            pump.decimate, pump._duty, pump._target_s = start, 0.35, 0.150
            pump._adapt(seconds, host)
            pumps.append(pump.decimate)
        assert pumps[0] == pumps[1], (start, seconds, pumps)


def test_pump_fetch_decimates_and_takes_newest():
    pump = DisplayPump()
    try:
        pump.close()
        batch = torch.stack([torch.full((8, 8, 3), k, dtype=torch.uint8) for k in (1, 2)])
        pump.decimate = 2
        got = pump._fetch(batch)
        assert got.shape == (4, 4, 3) and got[0, 0, 0] == 2
        pump.decimate = 1
        assert pump._fetch(batch).shape == (8, 8, 3)
    finally:
        pump.close()


def test_pump_duty_cycle_close_is_fast(monkeypatch):
    monkeypatch.setenv("SHADERFLOW_DISPLAY_DUTY", "0.01")   # long idles
    log = []
    pump = DisplayPump()
    try:
        pump.offer(SlowFrames(1, 0.05, log))   # 50 ms transfer -> about 5 s idle
        deadline = time.time() + 5.0
        while not log and time.time() < deadline:
            time.sleep(0.005)
        assert log
        started = time.perf_counter()
        pump.close()
        assert time.perf_counter() - started < 2.0
    finally:
        pump.close()


# --------------------------------------------------------------------------- #
# The SDL window under SDL's dummy video backend

def _post_script(pygame):
    """One posted event of every kind the window translates."""
    Event = pygame.event.Event
    return [
        Event(pygame.KEYDOWN, key=pygame.K_w, unicode="w", mod=0, scancode=26),
        Event(pygame.KEYDOWN, key=pygame.K_LCTRL, unicode="", mod=0, scancode=224),
        Event(pygame.MOUSEMOTION, pos=(10, 12), rel=(3, -2), buttons=(1, 0, 0)),
        Event(pygame.KEYUP, key=pygame.K_LCTRL, unicode="", mod=0, scancode=224),
        Event(pygame.MOUSEBUTTONDOWN, pos=(20, 8), button=1),
        Event(pygame.MOUSEMOTION, pos=(30, 9), rel=(10, 1), buttons=(1, 0, 0)),
        Event(pygame.MOUSEBUTTONUP, pos=(30, 9), button=1),
        Event(pygame.MOUSEMOTION, pos=(31, 20), rel=(1, 11), buttons=(0, 0, 0)),
        Event(pygame.MOUSEBUTTONDOWN, pos=(31, 20), button=3),
        Event(pygame.MOUSEBUTTONUP, pos=(31, 20), button=3),
        Event(pygame.MOUSEWHEEL, x=0, y=1, flipped=False),
        Event(pygame.MOUSEWHEEL, x=0, y=-2, flipped=False),
        Event(pygame.KEYDOWN, key=pygame.K_F1, unicode="", mod=0, scancode=58),
        Event(pygame.MOUSEMOTION, pos=(5, 5), rel=(-4, 2), buttons=(0, 0, 0)),
        Event(pygame.KEYUP, key=pygame.K_w, unicode="w", mod=0, scancode=26),
        Event(pygame.KEYDOWN, key=pygame.K_r, unicode="r", mod=0, scancode=21),
        Event(pygame.VIDEORESIZE, w=80, h=40, size=(80, 40)),
        Event(pygame.DROPFILE, file="/nonexistent/file.png"),
        Event(pygame.WINDOWLEAVE),
        Event(pygame.WINDOWENTER),
        Event(pygame.QUIT),
    ]


def _poll_posted(window_class, monkeypatch):
    pygame = pytest.importorskip("pygame")
    monkeypatch.setenv("SHADERFLOW_SDL_VIDEODRIVER", "dummy")
    window = window_class("test", 64, 32)
    try:
        window.poll()    # SDL's own start-up events
        for event in _post_script(pygame):
            pygame.event.post(event)
        return window.poll()
    finally:
        window.close()


def _record(scene):
    """The scene's relays, as (message class name, fields) in order."""
    relayed = []
    original = scene.relay

    def relay(message):
        if isinstance(message, type):
            message = message()
        relayed.append((type(message).__qualname__, dataclasses.asdict(message)))
        return original(message)

    scene.relay = relay
    return relayed


def _state(scene):
    return dict(quit=scene.quit, exclusive=scene.exclusive,
                mouse_gluv=tuple(round(v, 6) for v in scene.mouse_gluv),
                mouse_inside=scene.mouse_inside, mouse_buttons=dict(scene.mouse_buttons),
                resolution=scene.resolution,
                pressed={k: v for k, v in scene.keyboard._pressed.items() if k is not None},
                position=np.round(np.asarray(scene.camera.position.target, np.float64), 6)
                .tolist(),
                zoom=round(float(scene.camera.zoom.target), 6))


def test_sdl_window_events_and_relays_match_reference(monkeypatch):
    """The posted events come back as the same normalized tuples from both
    packages' windows, and each scene's _dispatch_window_events turns them
    into the same relays and the same state (mouse, buttons, keyboard,
    exclusive mode, camera, resolution, quit)."""
    pytest.importorskip("pygame")
    from test_torch_scene import _fix_reference_texture
    from shaderflow_tpu.io.sdlwindow import SDLWindow as ReferenceWindow
    from shaderflow_tpu.scene import ShaderScene as ReferenceScene
    from shaderflow_tpu.scene import WindowBackend as ReferenceBackend
    from shaderflow_tpu_torch.io.sdlwindow import SDLWindow
    from shaderflow_tpu_torch.scene import ShaderScene, WindowBackend

    events = _poll_posted(SDLWindow, monkeypatch)
    assert events == _poll_posted(ReferenceWindow, monkeypatch)
    _fix_reference_texture(monkeypatch)
    kinds = {event[0] for event in events}
    assert kinds >= {"keydown", "keyup", "unicode", "mousemove", "mousedown", "mouseup",
                     "wheel", "resize", "drop", "enter", "close"}

    results = []
    for cls, backend in ((ReferenceScene, ReferenceBackend), (ShaderScene, WindowBackend)):
        scene = cls(backend=backend.Headless)
        scene.initialize()
        scene.resize(width=64, height=32)
        relayed = _record(scene)
        scene._dispatch_window_events(events)
        results.append((relayed, _state(scene)))
    (want_relays, want_state), (got_relays, got_state) = results
    assert [name for name, _ in got_relays] == [name for name, _ in want_relays]
    for (name, got), (_, want) in zip(got_relays, want_relays):
        assert got.keys() == want.keys(), name
        for key in got:
            assert got[key] == pytest.approx(want[key], abs=1e-9), (name, key)
    assert got_state == want_state
    assert got_state["quit"] and got_state["exclusive"]


def test_sdl_close_quits_the_realtime_loop(monkeypatch):
    """A window close ends the loop before frame_limit."""
    pygame = pytest.importorskip("pygame")
    monkeypatch.setenv("SHADERFLOW_SDL_VIDEODRIVER", "dummy")
    monkeypatch.setenv("SHADERFLOW_AUDIO_BACKEND", "none")
    from shaderflow_tpu_torch.scene import ShaderScene, WindowBackend

    class Closing(ShaderScene):
        def update(self):
            if self._frame_counter == 3:
                pygame.event.post(pygame.event.Event(pygame.QUIT))

    scene = Closing(backend=WindowBackend.Preview)
    scene.frame_limit = 10 ** 6
    scene.main(width=32, height=16, fps=60, device="cpu")
    assert scene.quit and 3 < scene._frame_counter < 20
    assert scene._window is None and scene._display_pump is None


@pytest.mark.parametrize("sync", [False, True], ids=["async", "sync"])
def test_windowed_realtime_loop(monkeypatch, sync):
    """The windowed loop shows frames and dispatches events: through the
    pump by default (created, then closed at exit), or synchronously with
    SHADERFLOW_SYNC_DISPLAY=1 (no pump)."""
    pytest.importorskip("pygame")
    monkeypatch.setenv("SHADERFLOW_SDL_VIDEODRIVER", "dummy")
    if sync:
        monkeypatch.setenv("SHADERFLOW_SYNC_DISPLAY", "1")
    from shaderflow_tpu_torch.io import displaypump
    from shaderflow_tpu_torch.scene import ShaderScene, WindowBackend

    pumps = []
    monkeypatch.setattr(displaypump.DisplayPump, "__init__", (
        lambda original: lambda self: (pumps.append(self), original(self))[1])(
            displaypump.DisplayPump.__init__))
    shown = []
    scene = ShaderScene(backend=WindowBackend.Preview)
    opened = scene.open_window

    def open_window():
        window = opened()
        show = window.show
        window.show = lambda frame: (shown.append(frame.copy()), show(frame))[1]
        return window

    scene.open_window = open_window
    scene.frame_limit = 8
    scene.initialize()
    flushes = []
    flush = scene.engine.flush
    scene.engine.flush = lambda *a, **k: (flushes.append(a), flush(*a, **k))[1]
    scene.main(width=32, height=16, fps=60, frameskip=False, device="cpu")
    assert scene.frame >= 8 and shown and shown[-1].shape == (16, 32, 3)
    assert len(pumps) == (0 if sync else 1)
    assert scene._display_pump is None
    if not sync:
        # every launch is offered (a loaded machine may batch frames)
        assert pumps[0].offered == len(flushes)
        assert pumps[0].taken == len(shown)


def test_realtime_forced_micro_batch(monkeypatch):
    """SHADERFLOW_RT_BATCH=2 renders two frames a flush through the
    windowed loop, and the frame task paces at fps / 2."""
    pytest.importorskip("pygame")
    monkeypatch.setenv("SHADERFLOW_SDL_VIDEODRIVER", "dummy")
    monkeypatch.setenv("SHADERFLOW_RT_BATCH", "2")
    from shaderflow_tpu_torch.scene import ShaderScene, WindowBackend

    scene = ShaderScene(backend=WindowBackend.Preview)
    scene.frame_limit = 7
    scene.initialize()
    calls = []
    flush = scene.engine.flush
    scene.engine.flush = lambda *a, **k: (calls.append((a[0], scene.vsync.frequency)),
                                          flush(*a, **k))[1]
    scene.main(width=32, height=16, fps=60, device="cpu")
    assert scene.frame >= 7
    assert calls and all(n in (1, 2) for n, _ in calls) and any(n == 2 for n, _ in calls)
    # a two-frame launch covers two periods: the task paces at 30 a second
    assert all(frequency == pytest.approx(60.0 / n) for n, frequency in calls)


def test_cv2_preview_is_refused(monkeypatch):
    """SHADERFLOW_PREVIEW=cv2 takes the cv2 preview (it no longer refuses):
    the SDL window is not tried, frames go to OpenCV's window through the
    display pump, and F11 toggles its fullscreen property."""
    import sys

    from test_torch_preview_input import stub_cv2

    from shaderflow_tpu_torch.io import sdlwindow
    from shaderflow_tpu_torch.keyboard import ShaderKeyboard
    from shaderflow_tpu_torch.message import ShaderMessage
    from shaderflow_tpu_torch.scene import ShaderScene, WindowBackend
    monkeypatch.setenv("SHADERFLOW_PREVIEW", "cv2")
    monkeypatch.delenv("SHADERFLOW_SYNC_DISPLAY", raising=False)
    monkeypatch.setattr(sdlwindow, "SDLWindow", None)
    stub = stub_cv2()
    monkeypatch.setitem(sys.modules, "cv2", stub)
    scene = ShaderScene(backend=WindowBackend.Preview)
    scene.frame_limit = 6
    scene.initialize()
    original = scene._poll_input
    scene._poll_input = lambda code, now=None: (
        scene.relay(ShaderMessage.Keyboard.KeyDown(key=ShaderKeyboard.Keys.F11)) if scene.frame == 3 else None,
        original(code, now))[1]
    scene.main(width=32, height=16, fps=60, frameskip=False, device="cpu")
    names = [call[0] for call in stub.calls]
    assert "imshow" in names and "setWindowProperty" in names
    assert scene._display_pump is None and scene.fullscreen
