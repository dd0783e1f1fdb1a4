"""The realtime HUD of the PyTorch port (shaderflow_tpu_torch/scene.py
`_draw_hud`, `_hud_mouse`, `_ui_nudge`, the modules' ui / ui_fields /
ui_plots) against the JAX package: one case for each case of
tests/test_hud_edit.py, run on the port, and the HUD drawn on the same
frame from the same state bit-equal to the JAX package's. Everything runs
through the Keyboard message bus, as the SDL window, the X11 poller and
waitKey deliver keys."""

import itertools
import sys
from pathlib import Path

import numpy as np
import pytest
from test_torch_scene import _fix_reference_texture

from shaderflow_tpu_torch.keyboard import ShaderKeyboard
from shaderflow_tpu_torch.message import ShaderMessage
from shaderflow_tpu_torch.scene import ShaderScene

REPO = Path(__file__).resolve().parent.parent
Keys = ShaderKeyboard.Keys


def key(scene, code):
    scene.relay(ShaderMessage.Keyboard.KeyDown(key=code))


def select_module(scene, module) -> None:
    others = [m for m in scene.modules if m is not scene]
    scene._ui_index = others.index(module)
    scene._ui_field_index = 0


def make_scene():
    scene = ShaderScene()
    scene._setup_run(width=16, height=8, fps=10, time=0.1, freewheel=True, device="cpu")
    return scene


def test_dynamics_f_zeta_r_editable():
    scene = make_scene()
    dynamics = scene.camera.position
    select_module(scene, dynamics)
    f0 = dynamics.frequency
    key(scene, Keys.PLUS)
    assert np.isclose(dynamics.frequency, f0 + 0.1)
    key(scene, Keys.MINUS)
    key(scene, Keys.MINUS)
    assert np.isclose(dynamics.frequency, f0 - 0.1)
    key(scene, Keys.PERIOD)
    z0 = dynamics.zeta
    key(scene, Keys.EQUAL)
    assert np.isclose(dynamics.zeta, z0 + 0.1)
    key(scene, Keys.PERIOD)
    r0 = dynamics.response
    key(scene, Keys.MINUS)
    assert np.isclose(dynamics.response, r0 - 0.1)


def test_modifier_scales_step():
    scene = make_scene()
    dynamics = scene.camera.position
    select_module(scene, dynamics)
    f0 = dynamics.frequency
    scene.keyboard._pressed[Keys.LEFT_SHIFT] = True
    key(scene, Keys.PLUS)
    assert np.isclose(dynamics.frequency, f0 + 1.0)
    scene.keyboard._pressed[Keys.LEFT_SHIFT] = False
    scene.keyboard._pressed[Keys.LEFT_CTRL] = True
    key(scene, Keys.PLUS)
    assert np.isclose(dynamics.frequency, f0 + 1.0 + 0.01)


def test_field_bounds_clamp():
    scene = make_scene()
    dynamics = scene.camera.position
    select_module(scene, dynamics)
    scene.keyboard._pressed[Keys.LEFT_SHIFT] = True
    for _ in range(10):
        key(scene, Keys.MINUS)
    assert dynamics.frequency >= 0.01


def test_spectrogram_range_editable():
    sys.path.insert(0, str(REPO / "examples" / "torch"))
    import torch_demo

    scene = torch_demo.Visualizer()
    scene._setup_run(width=32, height=16, fps=10, time=0.1, freewheel=True, device="cpu")
    spectrogram = next(m for m in scene.modules if type(m).__name__ == "ShaderSpectrogram")
    select_module(scene, spectrogram)
    min0 = spectrogram.minimum_frequency
    key(scene, Keys.PLUS)
    assert np.isclose(spectrogram.minimum_frequency, min0 + 10.0)
    key(scene, Keys.PERIOD)
    max0 = spectrogram.maximum_frequency
    key(scene, Keys.MINUS)
    assert np.isclose(spectrogram.maximum_frequency, max0 - 500.0)


def test_camera_zoom_field():
    scene = make_scene()
    select_module(scene, scene.camera)
    zoom0 = float(scene.camera.zoom.target)
    key(scene, Keys.PLUS)
    assert np.isclose(float(scene.camera.zoom.target), zoom0 + 0.05)


def test_hud_renders_fields_with_marker():
    scene = make_scene()
    select_module(scene, scene.camera.position)
    frame = np.zeros((240, 320, 3), np.uint8)
    out = scene._draw_hud(frame.copy())
    assert out.std() > 0
    rows = [action for action in scene._hud_rows if action and action[0] == "field"]
    assert len(rows) == 3


def test_bracket_cycle_resets_field_selection():
    scene = make_scene()
    select_module(scene, scene.camera.position)
    key(scene, Keys.PERIOD)
    assert scene._ui_field_index == 1
    key(scene, Keys.BRACKET_RIGHT)
    assert scene._ui_field_index == 0


def draw_hud(scene):
    frame = np.zeros((scene.resolution[1], scene.resolution[0], 3), np.uint8)
    scene.render_ui = True
    scene._draw_hud(frame)
    return scene._hud_rows


def row_y(scene, row):
    return scene._HUD_ROW0 + scene._HUD_ROWH * row + 2


def test_hud_mouse_click_selects_module_and_field():
    scene = make_scene()
    scene.resize(width=640, height=480)
    rows = draw_hud(scene)
    module_rows = [i for i, a in enumerate(rows) if a and a[0] == "module"]
    assert len(module_rows) >= 3
    target = module_rows[-1]
    assert scene._hud_mouse("press", 10, row_y(scene, target))
    assert scene._ui_index == rows[target][1]
    rows = draw_hud(scene)
    field_rows = [i for i, a in enumerate(rows) if a and a[0] == "field"]
    if field_rows:
        assert scene._hud_mouse("press", 10, row_y(scene, field_rows[-1]))
        assert scene._ui_field_index == rows[field_rows[-1]][1]
    assert scene._hud_mouse("press", 10, row_y(scene, 0))
    assert not scene._hud_mouse("press", scene._HUD_WIDTH + 10, 40)


def test_hud_mouse_drag_and_wheel_edit_value():
    scene = make_scene()
    scene.resize(width=640, height=480)
    dynamics = scene.camera.position
    select_module(scene, dynamics)
    rows = draw_hud(scene)
    field_rows = [i for i, a in enumerate(rows) if a and a[0] == "field"]
    assert field_rows
    f0 = dynamics.frequency
    y = row_y(scene, field_rows[0])
    assert scene._hud_mouse("drag", 10, y, dx=5)
    assert np.isclose(dynamics.frequency, f0 + 0.1)
    assert scene._hud_mouse("wheel", 10, y, dy=-1)
    assert np.isclose(dynamics.frequency, f0)


def test_hud_toggle_off_consumes_nothing():
    scene = make_scene()
    scene.resize(width=640, height=480)
    draw_hud(scene)
    scene.render_ui = False
    assert not scene._hud_mouse("press", 10, 40)
    key(scene, Keys.TAB)
    assert scene.render_ui


def test_scene_panel_edits_speed_quality_ssaa():
    scene = make_scene()
    panels = scene._ui_panels()
    assert panels[-1] is scene
    scene._ui_index = len(panels) - 1
    scene._ui_field_index = 0
    key(scene, Keys.PLUS)
    assert np.isclose(scene.speed, 1.1)
    key(scene, Keys.PERIOD)
    key(scene, Keys.PLUS)
    assert scene.quality == 55.0
    key(scene, Keys.PERIOD)
    before = scene.render_resolution
    key(scene, Keys.PLUS)
    assert scene.ssaa == 1.25
    assert scene.render_resolution != before


def test_hud_sparkline_plots_render():
    scene = make_scene()
    for _ in range(12):
        scene.next(dt=0.1)
    timer = scene.frametimer
    assert timer.ui_plots()
    select_module(scene, timer)
    frame = np.full((480, 640, 3), 200, np.uint8)
    out = scene._draw_hud(frame.copy())
    assert (out == 255).any() and (out < 64).any()
    dynamics = scene.camera.position
    for _ in range(8):
        scene.next(dt=0.1)
    assert dynamics.ui_plots()
    select_module(scene, dynamics)
    assert (scene._draw_hud(frame.copy()) == 255).any()


def test_hud_with_pygame_text_when_cv2_is_missing(monkeypatch):
    """Without cv2 the HUD's text goes through SDLWindow.draw_text
    (pygame.font), at the cv2 path's rows."""
    pytest.importorskip("pygame")
    scene = make_scene()
    select_module(scene, scene.camera)
    monkeypatch.setitem(sys.modules, "cv2", None)
    out = scene._draw_hud(np.zeros((240, 320, 3), np.uint8))
    assert (out > 128).any() and len(scene._hud_rows) > 5


# --------------------------------------------------------------------------- #
# The HUD bit-equal to the JAX package's

def both_scenes(monkeypatch):
    """The same bare scene in both packages, module uuids from 1, its
    frametimer fed the same twelve deltas."""
    _fix_reference_texture(monkeypatch)
    import shaderflow_tpu.module as jax_module
    import shaderflow_tpu.scene as jax_scene
    import shaderflow_tpu_torch.module as port_module
    scenes = []
    for module, scene_cls, kwargs in ((jax_module, jax_scene.ShaderScene, {}),
                                      (port_module, ShaderScene, {"device": "cpu"})):
        monkeypatch.setattr(module, "_uuid_counter", itertools.count(1))
        scene = scene_cls()
        scene._setup_run(width=640, height=360, fps=10, time=0.1, freewheel=True, **kwargs)
        for dt in np.linspace(0.05, 0.16, 12):
            scene.next(dt=float(dt))
        scenes.append(scene)
    return scenes


@pytest.mark.parametrize("panel", ["position", "frametimer", "camera", "scene", "keyboard"])
def test_draw_hud_bit_equal_to_jax(monkeypatch, panel):
    """_draw_hud on the same seeded frame with the same panel selected (a
    dynamics module with its plot, the frametimer's plot, the camera's
    fields, the scene's own panel, a module without a panel) draws the
    same bytes and the same hit map as the JAX package's."""
    jax_scene, port = both_scenes(monkeypatch)
    frame = np.random.default_rng(5).integers(0, 256, (360, 640, 3), dtype=np.uint8)
    outs = []
    for scene in (jax_scene, port):
        module = {"position": scene.camera.position, "frametimer": scene.frametimer,
                  "camera": scene.camera, "scene": scene, "keyboard": scene.keyboard}[panel]
        scene._ui_index = scene._ui_panels().index(module)
        scene._ui_field_index = 1
        scene.render_ui = True
        outs.append((scene._draw_hud(frame.copy()), list(scene._hud_rows)))
    (want, want_rows), (got, got_rows) = outs
    assert got_rows == want_rows
    assert np.array_equal(got, want), int((got != want).sum())
