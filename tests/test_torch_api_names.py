"""The JAX package's remaining public names in the PyTorch port, one case
each, held to the JAX value or behaviour on the same inputs (made from a
seed with numpy): Scene, ShaderTexture, ShaderModule, the keyboard's key
uniforms and keymap, the variable kinds, messages, the camera's target
setter, CameraRays, Frag.has_prelude, tailfuse.backend_supports_fusion
and the nearest table lookups (bit-equal in each mode and precision).
Values are equal unless a case says otherwise."""

import logging

import numpy as np
import pytest
import torch
from test_torch_scene import _fix_reference_texture, _import_example


def _both(monkeypatch):
    """(port demo module, JAX demo module), the reference texture fixed."""
    _fix_reference_texture(monkeypatch)
    return _import_example("torch", "torch_demo"), _import_example("basic", "demo")


def _host(value):
    if isinstance(value, torch.Tensor):
        if value.dtype == torch.bfloat16:
            return value.view(torch.int16).numpy(), "bfloat16"
        return value.numpy(), str(value.dtype).removeprefix("torch.")
    value = np.asarray(value)
    if value.dtype.name == "bfloat16":
        return value.view(np.int16), "bfloat16"
    return value, value.dtype.name


def _same_arrays(got, want) -> None:
    (got, got_type), (want, want_type) = _host(got), _host(want)
    assert got_type == want_type and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# -- Scene -------------------------------------------------------------------

def scene_cycle(monkeypatch):
    port, jax = _both(monkeypatch)
    values = []
    for scene in (port.ShaderToy(), jax.ShaderToy()):
        scene.runtime, scene.time = 3.0, 4.3
        values.append(scene.cycle)
    return values


def scene_components(monkeypatch):
    port, jax = _both(monkeypatch)
    values = []
    for scene in (port.ShaderToy(), jax.ShaderToy()):
        scene.initialize()
        values.append(scene.components)
    assert values[0] == 3
    return values


# -- ShaderTexture ---------------------------------------------------------------

def _textures(monkeypatch):
    from shaderflow_tpu.texture import ShaderTexture as Reference
    from shaderflow_tpu_torch.texture import ShaderTexture
    port, jax = _both(monkeypatch)
    made = []
    for cls, scene in ((ShaderTexture, port.Basic()), (Reference, jax.Basic())):
        made.append(cls(scene=scene, name="iTable", width=5, height=3, components=3,
                        dtype=np.uint8, temporal=2, layers=3))
    return made


def texture_aspect_ratio(monkeypatch):
    return [texture.aspect_ratio for texture in _textures(monkeypatch)]


def texture_zeros(monkeypatch):
    zeros = [texture.zeros for texture in _textures(monkeypatch)]
    _same_arrays(*zeros)
    return [zeros[0].shape, str(zeros[0].dtype)], [zeros[1].shape, str(zeros[1].dtype)]


def texture_bytes_per_pixel(monkeypatch):
    return [texture.bytes_per_pixel for texture in _textures(monkeypatch)]


def texture_size_t(monkeypatch):
    return [texture.size_t for texture in _textures(monkeypatch)]


def texture_is_empty(monkeypatch):
    values = []
    data = np.random.default_rng(1).integers(0, 255, (3, 5, 3), dtype=np.uint8)
    for texture in _textures(monkeypatch):
        before = texture.is_empty()
        texture.write(data, temporal=1, layer=2)
        values.append((before, texture.is_empty()))
    assert values[0] == (True, False)
    return values


def texture_sampler_names(monkeypatch):
    return [list(texture.sampler_names()) for texture in _textures(monkeypatch)]


# -- ShaderModule ------------------------------------------------------------------

def module_find(monkeypatch):
    from shaderflow_tpu.shader import ShaderProgram as Reference
    from shaderflow_tpu_torch.shader import ShaderProgram
    port, jax = _both(monkeypatch)
    values = []
    for scene, kind in ((port.MultiShader(), ShaderProgram), (jax.MultiShader(), Reference)):
        scene.initialize()
        values.append([module.name for module in scene.find(kind)])
    assert len(values[0]) >= 3
    return values


def module_who(monkeypatch):
    port, jax = _both(monkeypatch)
    values = []
    for scene in (port.ShaderToy(), jax.ShaderToy()):
        scene.initialize()
        scene.camera.uuid = 7
        values.append(scene.camera.who)
    return values


def _logged(monkeypatch, caplog, method: str):
    port, jax = _both(monkeypatch)
    values = []
    for name in ("shaderflow_tpu_torch", "shaderflow_tpu"):
        caplog.set_level(logging.DEBUG, logger=name)
    for scene in (port.ShaderToy(), jax.ShaderToy()):
        scene.uuid = 3
        with caplog.at_level(logging.DEBUG):
            caplog.clear()
            text = getattr(scene, method)("frame", 12, "ready")
            records = [(r.levelname, r.getMessage()) for r in caplog.records]
        values.append((text, records))
    assert values[0][0] == values[0][1][0][1] and "frame 12 ready" in values[0][0]
    return values


def module_log_info(monkeypatch, caplog):
    return _logged(monkeypatch, caplog, "log_info")


def module_log_warn(monkeypatch, caplog):
    return _logged(monkeypatch, caplog, "log_warn")


def module_log_error(monkeypatch, caplog):
    return _logged(monkeypatch, caplog, "log_error")


def module_log_debug(monkeypatch, caplog):
    return _logged(monkeypatch, caplog, "log_debug")


def module_log_minor(monkeypatch, caplog):
    return _logged(monkeypatch, caplog, "log_minor")


# -- keyboard ----------------------------------------------------------------------

def keyboard_pipeline(monkeypatch):
    from shaderflow_tpu.keyboard import ShaderKeyboard as Reference
    from shaderflow_tpu.message import ShaderMessage as ReferenceMessage
    from shaderflow_tpu_torch.keyboard import ShaderKeyboard
    from shaderflow_tpu_torch.message import ShaderMessage
    port, jax = _both(monkeypatch)
    values = []
    for scene, cls, message in ((port.Basic(), ShaderKeyboard, ShaderMessage),
                                (jax.Basic(), Reference, ReferenceMessage)):
        silent = cls(scene=scene)
        keyboard = cls(scene=scene, export_keys=True)
        keyboard.handle(message.Keyboard.KeyDown(key=cls.Keys.W))
        keyboard.handle(message.Keyboard.Press(key=cls.Keys.SPACE, action=1))
        values.append((list(silent.pipeline()),
                       [(u.type, u.name, bool(u.value), u.qualifier)
                        for u in keyboard.pipeline()]))
    pressed = [name for _, name, value, _ in values[0][1] if value]
    assert pressed == ["iKeyW", "iKeySpace"] and len(values[0][1]) > 40
    return values


def keyboard_set_keymap(monkeypatch):
    from shaderflow_tpu.keyboard import ShaderKeyboard as Reference
    from shaderflow_tpu_torch.keyboard import ShaderKeyboard
    port, jax = _both(monkeypatch)
    values = []
    for cls, scene in ((ShaderKeyboard, port.Basic()), (Reference, jax.Basic())):
        monkeypatch.setattr(cls, "Keys", cls.Keys)   # restored after the case

        class Keymap:
            ACTION_PRESS, ACTION_RELEASE = 1, 0
            FIRE, JUMP = 300, 301

        cls.set_keymap(Keymap)
        keyboard = cls(scene=scene, export_keys=True)
        keyboard._pressed[Keymap.JUMP] = True
        values.append((cls.Keys is Keymap, [(u.name, bool(u.value)) for u in keyboard.pipeline()]))
    assert values[0] == (True, [("iKeyFire", False), ("iKeyJump", True)])
    return values


# -- variables -----------------------------------------------------------------------

def _variable_kind(name):
    def case(monkeypatch):
        import shaderflow_tpu.variable as reference
        import shaderflow_tpu_torch.variable as port
        values = []
        for module in (port, reference):
            plain = getattr(module, name)("vec2", "iUv", (0.25, 0.5))
            flat = getattr(module, name)("int", "iIndex", 3, direction="out")
            values.append([(repr(v), v.declaration, v.direction, v.interpolation, v.qualifier,
                            v.coerce().tolist()) for v in (plain, flat)])
        return values
    return case


def variable_copy(monkeypatch):
    import shaderflow_tpu.variable as reference
    import shaderflow_tpu_torch.variable as port
    values = []
    for module in (port, reference):
        original = module.FlatVariable("vec3", "iColor", (1, 2, 3), direction="out")
        copied = original.copy(name="iTint", value=(0, 1, 0))
        values.append((type(copied).__name__, repr(copied), copied.declaration,
                       repr(original), copied is not original))
    return values


def variable_declaration(monkeypatch):
    import shaderflow_tpu.variable as reference
    import shaderflow_tpu_torch.variable as port
    values = []
    for module in (port, reference):
        values.append([module.Uniform("float", "iTime").declaration,
                       module.StaticUniform("int", "iMode", 2).declaration,
                       module.ShaderVariable("vec4", "fragColor", direction="out",
                                             interpolation="smooth").declaration])
    assert values[0][0] == "uniform float iTime;"
    return values


# -- messages --------------------------------------------------------------------------

def message_custom(monkeypatch):
    from shaderflow_tpu.message import ShaderMessage as Reference
    from shaderflow_tpu_torch.message import ShaderMessage
    values = []
    for message in (ShaderMessage, Reference):
        custom = message.Custom()
        custom.data = {"cue": 4}
        values.append((message.Custom.__qualname__, message.Custom.__annotations__ and
                       sorted(message.Custom.__annotations__), custom.data,
                       hasattr(message.Custom, "__dataclass_fields__")))
    return values


def message_render(monkeypatch):
    from shaderflow_tpu.message import ShaderMessage as Reference
    from shaderflow_tpu_torch.message import ShaderMessage
    return [(repr(m.Shader.Render()), m.Shader.Render() == m.Shader.Render())
            for m in (ShaderMessage, Reference)]


def _file_drop(accessor):
    def case(monkeypatch):
        from shaderflow_tpu.message import ShaderMessage as Reference
        from shaderflow_tpu_torch.message import ShaderMessage
        values = []
        for message in (ShaderMessage, Reference):
            drops = [message.Window.FileDrop(files=files)
                     for files in ([], ["a.png"], ["a.png", "b.mp4", "c.wav"])]
            values.append([accessor(drop) for drop in drops])
        return values
    return case


# -- camera --------------------------------------------------------------------------------

def _jax_camera_fields(jax):
    scene = jax.ShaderToy()
    scene.initialize()
    return scene.camera, scene.camera.ui_fields()


def camera_target_setter(monkeypatch):
    from shaderflow_tpu_torch.camera import target_setter
    port, jax = _both(monkeypatch)
    scene = port.ShaderToy()
    scene.initialize()
    camera, fields = _jax_camera_fields(jax)
    setters = [target_setter(scene.camera.zoom), target_setter(scene.camera.isometric),
               target_setter(scene.camera.dolly)]
    for setter, field, value in zip(setters, fields, (2.5, 0.25, -0.5)):
        setter(value)
        field.set(value)
    return ([s.__name__ for s in setters] + [float(scene.camera.zoom.target),
                                             float(scene.camera.isometric.target),
                                             float(scene.camera.dolly.target)],
            [f.set.__name__ for f in fields] + [float(camera.zoom.target),
                                                float(camera.isometric.target),
                                                float(camera.dolly.target)])


def camera_set(monkeypatch):
    """set() moves the target, not the value: the dynamics glide there."""
    from shaderflow_tpu_torch.camera import target_setter
    port, jax = _both(monkeypatch)
    scene = port.ShaderToy()
    scene.initialize()
    camera, fields = _jax_camera_fields(jax)
    values = []
    for zoom, set_zoom in ((scene.camera.zoom, target_setter(scene.camera.zoom)),
                           (camera.zoom, fields[0].set)):
        before = float(np.asarray(zoom.value))
        set_zoom(3.0)
        values.append((before, float(np.asarray(zoom.value)), float(zoom.target)))
    assert values[0] == (1.0, 1.0, 3.0)
    return values


# -- ray fields ---------------------------------------------------------------------------------

def _rays(height=18, width=32):
    from shaderflow_tpu.ops.cameralib import project_trivial as reference
    from shaderflow_tpu_torch.ops.cameralib import project_trivial
    rng = np.random.default_rng(9)
    aspect = width / height
    x = np.sort(rng.uniform(-aspect, aspect, width)).astype(np.float32)
    y = np.sort(rng.uniform(-1, 1, height)).astype(np.float32)
    options = dict(position=[0.1, -0.2, 0.3], zoom=1.25, isometric=0.2, orbital=0.1,
                   dolly=0.05, focal_length=1.0, aspect=aspect, want_aspect=aspect,
                   resolution=[width, height])
    import jax.numpy as jnp
    return (project_trivial(gluv_x=torch.from_numpy(x), gluv_y=torch.from_numpy(y), **options),
            reference(gluv_x=jnp.asarray(x), gluv_y=jnp.asarray(y), **options))


def rays_ray_direction(monkeypatch):
    """Held within 2 float32 ulps of 1 (the norm's sqrt and division may
    fuse differently under XLA); the shapes and the unit length exactly."""
    got, want = (np.asarray(r.ray_direction) for r in _rays())
    assert got.shape == want.shape == (18, 32, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)
    return [got.shape], [want.shape]


def rays_grid(monkeypatch):
    """cameralib.grid materializes a field from its axis lines: the port's
    gluv, stuv and astuv grids equal the JAX fields the reference's grid
    builds."""
    from shaderflow_tpu_torch.ops.cameralib import grid
    port, reference = _rays()
    x, y = port.line("gluv")
    _same_arrays(grid(x, y, 18, 32), np.asarray(reference.gluv))
    return ([tuple(port.stuv.shape), port.astuv.numpy().tolist()],
            [tuple(reference.stuv.shape), np.asarray(reference.astuv).tolist()])


# -- the rest -------------------------------------------------------------------------------------

def frag_has_prelude(monkeypatch):
    from shaderflow_tpu.shader import Frag as Reference
    from shaderflow_tpu_torch.shader import Frag
    values = []
    for cls in (Frag, Reference):
        frag = cls.__new__(cls)
        frag._preludes = {"iBarField": np.zeros(3)}
        values.append([frag.has_prelude("iBarField"), frag.has_prelude("iWaveform")])
    assert values[0] == [True, False]
    return values


def tailfuse_backend_supports_fusion(monkeypatch):
    """On the CPU no fused kernel runs in either package; the port's K1 runs
    for CUDA tensors."""
    from shaderflow_tpu.ops import tailfuse as reference
    from shaderflow_tpu_torch.ops import tailfuse
    monkeypatch.delenv("SHADERFLOW_TAILFUSE_INTERPRET", raising=False)
    monkeypatch.delenv("SHADERFLOW_NO_TAILFUSE", raising=False)
    assert tailfuse.backend_supports_fusion("cuda") and tailfuse.backend_supports_fusion(
        torch.device("cuda", 0))
    return tailfuse.backend_supports_fusion("cpu"), reference.backend_supports_fusion()


def _table(repeat_y: bool, seed: int = 4):
    """A (47, 1, 3) table texture of both packages, and a v field reaching
    outside [0, 1] (clamped or wrapped rows)."""
    from shaderflow_tpu.ops.sampling import Sampler2D as Reference
    from shaderflow_tpu_torch.ops.sampling import Sampler2D
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((47, 1, 3)).astype(np.float32)
    v = rng.uniform(-0.3, 1.3, (21, 34)).astype(np.float32)
    return ((Sampler2D(torch.from_numpy(table), linear=False, repeat_y=repeat_y),
             torch.from_numpy(v)),
            (Reference(jnp.asarray(table), linear=False, repeat_y=repeat_y), jnp.asarray(v)))


def _lookup(mode, precision):
    def case(monkeypatch):
        from shaderflow_tpu.ops.sampling import lookup_nearest_1d as reference
        from shaderflow_tpu_torch.ops.sampling import lookup_nearest_1d
        for repeat_y in (False, True):
            port, jax = _table(repeat_y)
            _same_arrays(lookup_nearest_1d(*port, mode=mode, precision=precision),
                         reference(*jax, mode=mode, precision=precision))
        return True, True
    return case


def _lookup_planes(precision):
    def case(monkeypatch):
        from shaderflow_tpu.ops.sampling import lookup_nearest_1d_planes as reference
        from shaderflow_tpu_torch.ops.sampling import lookup_nearest_1d_planes
        for repeat_y in (False, True):
            port, jax = _table(repeat_y)
            got = lookup_nearest_1d_planes(*port, precision=precision)
            want = reference(*jax, precision=precision)
            assert len(got) == len(want) == 3
            for a, b in zip(got, want):
                _same_arrays(a, b)
        return True, True
    return case


CASES = {
    "Scene.cycle": scene_cycle,
    "Scene.components": scene_components,
    "ShaderTexture.aspect_ratio": texture_aspect_ratio,
    "ShaderTexture.zeros": texture_zeros,
    "ShaderTexture.bytes_per_pixel": texture_bytes_per_pixel,
    "ShaderTexture.size_t": texture_size_t,
    "ShaderTexture.is_empty": texture_is_empty,
    "ShaderTexture.sampler_names": texture_sampler_names,
    "ShaderModule.find": module_find,
    "ShaderModule.who": module_who,
    "ShaderModule.log_info": module_log_info,
    "ShaderModule.log_warn": module_log_warn,
    "ShaderModule.log_error": module_log_error,
    "ShaderModule.log_debug": module_log_debug,
    "ShaderModule.log_minor": module_log_minor,
    "ShaderKeyboard.pipeline": keyboard_pipeline,
    "ShaderKeyboard.set_keymap": keyboard_set_keymap,
    "variable.InVariable": _variable_kind("InVariable"),
    "variable.OutVariable": _variable_kind("OutVariable"),
    "variable.FlatVariable": _variable_kind("FlatVariable"),
    "ShaderVariable.copy": variable_copy,
    "ShaderVariable.declaration": variable_declaration,
    "ShaderMessage.Custom": message_custom,
    "ShaderMessage.Shader.Render": message_render,
    "FileDrop.get": _file_drop(lambda drop: [drop.get(0), drop.get(1), drop.get(9)]),
    "FileDrop.second": _file_drop(lambda drop: drop.second),
    "FileDrop.third": _file_drop(lambda drop: drop.third),
    "camera.target_setter": camera_target_setter,
    "camera.set": camera_set,
    "CameraRays.ray_direction": rays_ray_direction,
    "cameralib.grid": rays_grid,
    "ShaderProgram.has_prelude": frag_has_prelude,
    "tailfuse.backend_supports_fusion": tailfuse_backend_supports_fusion,
    "lookup_nearest_1d[onehot-float32]": _lookup("onehot", "float32"),
    "lookup_nearest_1d[onehot-bfloat16]": _lookup("onehot", "bfloat16"),
    "lookup_nearest_1d[select-float32]": _lookup("select", "float32"),
    "lookup_nearest_1d_planes[bfloat16]": _lookup_planes("bfloat16"),
    "lookup_nearest_1d_planes[float32]": _lookup_planes("float32"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_public_name_matches_jax(name, monkeypatch, request):
    case = CASES[name]
    arguments = {"monkeypatch": monkeypatch}
    if "caplog" in case.__code__.co_varnames[:case.__code__.co_argcount]:
        arguments["caplog"] = request.getfixturevalue("caplog")
    got, want = case(**arguments)
    assert got == want
