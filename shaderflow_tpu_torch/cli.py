"""
CLI launcher: `python -m shaderflow_tpu_torch [<file.py>] <Scene> main --flags`.

Port of shaderflow_tpu/cli.py: discovers ShaderScene subclasses, builds an
argument parser from Scene.main's signature (so the flag surface is the
method signature, `--device` included: "cuda" by default, and a run
without a card raises unless `--device cpu` is given), and takes the
chainable codec/filter subcommand grammar:

    Scene main -o out.mkv h264 --crf 18 --preset fast aac --bitrate 192k

Each subcommand's flags derive from the codec constructor's signature
(io/ffmpeg.py), so the CLI surface is the FFmpeg class's API; --vcodec/--acodec
flags remain as a compact alternative spelling. `<Scene> <command>` runs a
module-registered command (module.register_command). Without a file, the
scenes of the port's examples/torch/ are offered.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import sys
import typing
from pathlib import Path
from typing import Optional, Sequence

from shaderflow_tpu_torch import logger
from shaderflow_tpu_torch.scene import ShaderScene

VCODECS = ("h264", "h264_nvenc", "h264_qsv", "h264_amf",
           "h265", "h265_nvenc", "h265_qsv", "h265_amf",
           "av1_svt", "av1_rav1e", "av1_nvenc",
           "rawvideo", "copy_video", "no_video")
ACODECS = ("aac", "mp3", "opus", "flac", "pcm", "copy_audio", "no_audio", "empty_audio")

# Which keyword each codec function accepts (io/ffmpeg.py);
# flags outside a codec's surface are rejected loudly instead of silently
# dropped
VCODEC_OPTIONS = {
    "h264": ("crf", "preset", "tune", "profile"),
    "h265": ("crf", "preset"),
    "h264_nvenc": ("cq", "preset", "tune"),
    "h265_nvenc": ("cq", "preset", "tune"),
    "h264_qsv": ("crf", "preset"),
    "h265_qsv": ("crf", "preset"),
    "h264_amf": ("crf", "preset"),
    "h265_amf": ("crf", "preset"),
    "av1_svt": ("crf", "preset"),
    "av1_rav1e": ("crf", "preset"),
    "av1_nvenc": ("cq", "preset"),
}
ACODEC_OPTIONS = {"aac": ("bitrate",), "mp3": ("bitrate",), "opus": ("bitrate",)}

# Subcommand spellings that differ from the FFmpeg method names
_CHAIN_ALIASES = {"acopy": "copy_audio", "anone": "no_audio",
                  "aempty": "empty_audio", "vcopy": "copy_video",
                  "vnone": "no_video"}


def _chain_registry() -> dict:
    """Chainable subcommand name -> (FFmpeg method, option-signature
    source): `Scene main -o out.mkv h264 --crf 18 aac --bitrate 192k scale
    --width 1280` derives each subcommand's flags from the codec
    constructor's signature, so the option surface is the FFmpeg API."""
    from shaderflow_tpu_torch.io import ffmpeg as ffm
    registry: dict[str, tuple[str, object]] = {}
    for name, ctor in (
            ("h264", ffm.H264), ("h264_nvenc", ffm.H264_NVENC),
            ("h264_qsv", ffm.H264_QSV), ("h264_amf", ffm.H264_AMF),
            ("h265", ffm.H265), ("h265_nvenc", ffm.H265_NVENC),
            ("h265_qsv", ffm.H265_QSV), ("h265_amf", ffm.H265_AMF),
            ("av1_svt", ffm.AV1_SVT), ("av1_rav1e", ffm.AV1_RAV1E),
            ("av1_nvenc", ffm.AV1_NVENC), ("rawvideo", ffm.Rawvideo),
            ("copy_video", ffm.CopyVideo), ("no_video", ffm.NoVideo),
            ("aac", ffm.AAC), ("mp3", ffm.MP3), ("opus", ffm.Opus),
            ("flac", ffm.FLAC), ("pcm", ffm.PCM),
            ("copy_audio", ffm.CopyAudio), ("no_audio", ffm.NoAudio),
            ("empty_audio", ffm.EmptyAudio)):
        registry[name] = (name, ctor)
    # Filters chain the same way; their signatures live on FFmpeg
    for name in ("scale", "vflip"):
        registry[name] = (name, getattr(ffm.FFmpeg, name))
    return registry


def _normalize_chain(token: str) -> str:
    name = token.replace("-", "_")
    return _CHAIN_ALIASES.get(name, name)


def _split_chained(argv: list[str], registry: dict) -> tuple[list, list]:
    """Split `main` argv at chainable subcommand names: flags before the
    first command name belong to main; each command owns the flags that
    follow it until the next command name."""
    main_argv: list[str] = []
    segments: list[list[str]] = []
    expect_value = False
    for token in argv:
        # A flag's separated value is never read as a command name
        # (`--vcodec h264` stays a flag pair). A boolean flag directly
        # followed by a command name also pairs: write bool flags last or
        # use --flag=value forms when mixing.
        if (not token.startswith("-") and not expect_value
                and _normalize_chain(token) in registry):
            segments.append([token])
            expect_value = False
            continue
        (segments[-1] if segments else main_argv).append(token)
        expect_value = token.startswith("-") and "=" not in token
    return main_argv, segments


def _chain_parser(display: str, source) -> argparse.ArgumentParser:
    """Derive a subcommand parser from a codec constructor / FFmpeg method
    signature (VAR_KEYWORD passthroughs excluded: the CLI surface is the
    documented options)."""
    parser = argparse.ArgumentParser(prog=display, description=inspect.getdoc(source))
    signature = inspect.signature(source, eval_str=True)
    for name, parameter in signature.parameters.items():
        if name == "self" or parameter.kind in (
                inspect.Parameter.VAR_KEYWORD, inspect.Parameter.VAR_POSITIONAL):
            continue
        default = parameter.default
        if default is inspect.Parameter.empty:
            default = None
        annotation = parameter.annotation
        candidates = ((annotation,) if typing.get_origin(annotation) is None
                      else typing.get_args(annotation))
        kind = next((c for c in candidates if c in (int, float, str)), None)
        if kind is None:
            kind = type(default) if isinstance(default, (int, float)) else str
        parser.add_argument(f"--{name}", dest=name, type=kind, default=default)
    return parser


def apply_chained(scene, segments: list) -> bool:
    """Run the chained codec/filter subcommands against the scene's FFmpeg
    command; False (after a loud message) on a bad option."""
    registry = _chain_registry()
    for segment in segments:
        method, source = registry[_normalize_chain(segment[0])]
        parser = _chain_parser(segment[0], source)
        try:
            options = vars(parser.parse_args(segment[1:]))
        except SystemExit:
            return False
        getattr(scene.ffmpeg, method)(**options)
    return True


def _add_main_flags(parser: argparse.ArgumentParser) -> None:
    """Mirror Scene.main's keyword arguments as CLI flags."""
    signature = inspect.signature(ShaderScene.main, eval_str=True)
    shorthand = {"width": "-w", "height": "-h", "scale": "-x", "ratio": "-r",
                 "fps": "-f", "quality": "-q", "ssaa": "-s", "output": "-o",
                 "time": "-t"}
    for name, parameter in signature.parameters.items():
        if name == "self":
            continue
        default = parameter.default
        annotation = parameter.annotation
        origin = typing.get_origin(annotation)
        args = [f"--{name}"]
        if name in shorthand:
            args.append(shorthand[name])
        if annotation is bool or isinstance(default, bool):
            group = parser.add_mutually_exclusive_group()
            group.add_argument(*args, dest=name, action="store_true", default=default)
            group.add_argument(f"--no-{name}", dest=name, action="store_false")
            continue
        candidates = (annotation,) if origin is None else typing.get_args(annotation)
        kind = str
        # Union[float, str] params (ratio '16:9', time 'MM:SS') must stay
        # strings: the scene's own parsers handle the rich forms.
        if str not in candidates:
            for candidate in candidates:
                if candidate in (int, float):
                    kind = candidate
                    break
        parser.add_argument(*args, dest=name, type=kind, default=default)


def discover_scenes(path: Path) -> list[type]:
    """Import a python file and collect its ShaderScene subclasses."""
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[path.stem] = module
    spec.loader.exec_module(module)
    scenes = []
    for value in vars(module).values():
        if (isinstance(value, type) and issubclass(value, ShaderScene)
                and value is not ShaderScene):
            scenes.append(value)
    return scenes


def launch(scenes: Sequence[type], argv: Optional[list[str]] = None):
    """Dispatch `<Scene> main --flags` over a scene collection."""
    argv = list(sys.argv[1:] if argv is None else argv)
    names = {scene.__name__: scene for scene in scenes}

    if not argv or argv[0] in ("-h", "--help"):
        print("Available scenes:")
        for name, scene in names.items():
            print(f"  {name:<16} {inspect.getdoc(scene) or ''}")
        print("\nUsage: <Scene> main [--flags] (see '<Scene> main --help')")
        return None

    scene_name = argv.pop(0)
    if scene_name not in names:
        logger.error(f"Unknown scene {scene_name!r}; available: {', '.join(names)}")
        return None

    command = argv.pop(0) if argv and not argv[0].startswith("-") else "main"
    if command != "main":
        return _run_module_command(names[scene_name], command, argv)

    registry = _chain_registry()
    argv, chained = _split_chained(argv, registry)

    parser = argparse.ArgumentParser(
        prog=f"{scene_name} main",
        description=inspect.getdoc(names[scene_name]),
        epilog="Chainable encoder/filter subcommands: "
               "append e.g. `h264 --crf 18 aac --bitrate 192k scale "
               f"--width 1280`. Available: {', '.join(sorted(registry))}",
        add_help=False,
    )
    parser.add_argument("--help", action="help")
    _add_main_flags(parser)
    parser.add_argument("--vcodec", choices=VCODECS, default=None,
                        help="Video codec (or chain a codec command after main)")
    parser.add_argument("--acodec", choices=ACODECS, default=None)
    parser.add_argument("--crf", type=int, default=None, help="Constant rate factor")
    parser.add_argument("--cq", type=int, default=None, help="NVENC constant quality")
    parser.add_argument("--preset", type=str, default=None, help="Encoder preset")
    parser.add_argument("--tune", type=str, default=None, help="Encoder tune")
    parser.add_argument("--profile", type=str, default=None, help="H.264 profile")
    parser.add_argument("--bitrate", type=str, default=None, help="Audio bitrate (e.g. 192k)")
    options = vars(parser.parse_args(argv))

    vcodec = options.pop("vcodec")
    acodec = options.pop("acodec")
    codec_flags = {key: options.pop(key)
                   for key in ("crf", "cq", "preset", "tune", "profile", "bitrate")}

    scene = names[scene_name]()
    if vcodec:
        allowed = VCODEC_OPTIONS.get(vcodec, ())
        extra = {}
        for key in ("crf", "cq", "preset", "tune", "profile"):
            if codec_flags[key] is None:
                continue
            if key not in allowed:
                logger.error(f"--{key} is not an option of --vcodec {vcodec} "
                             f"(accepts: {', '.join(allowed) or 'none'})")
                return None
            extra[key] = codec_flags[key]
        getattr(scene.ffmpeg, vcodec)(**extra)
    if acodec:
        extra = {}
        if codec_flags["bitrate"] is not None:
            if "bitrate" not in ACODEC_OPTIONS.get(acodec, ()):
                logger.error(f"--bitrate is not an option of --acodec {acodec}")
                return None
            extra["bitrate"] = codec_flags["bitrate"]
        getattr(scene.ffmpeg, acodec)(**extra)
    if not apply_chained(scene, chained):
        return None
    return scene.main(**options)


def _run_module_command(scene_class: type, command: str,
                        argv: list[str]):
    """Dispatch a module-registered command (module.register_command):
    `<Scene> <command> [--flags]`. The scene initializes first so build()
    hooks register their commands."""
    scene = scene_class()
    scene.initialize()
    if command not in scene._commands:
        known = ", ".join(sorted(scene._commands)) or "(none)"
        logger.error(f"Unknown command {command!r}; module commands: {known}")
        return None
    fn = scene._commands[command]
    parser = argparse.ArgumentParser(prog=command, description=inspect.getdoc(fn))
    for name, parameter in inspect.signature(fn).parameters.items():
        if name == "self":
            continue
        default = parameter.default
        required = default is inspect.Parameter.empty
        annotation = parameter.annotation
        kind = annotation if annotation in (int, float, str) else (
            type(default) if not required and default is not None else str)
        if kind is bool or isinstance(default, bool):
            parser.add_argument(f"--{name.replace('_', '-')}",
                                action="store_true", default=bool(default))
        else:
            parser.add_argument(f"--{name.replace('_', '-')}", dest=name,
                                type=kind, default=None if required else default,
                                required=required)
    return fn(**vars(parser.parse_args(argv)))


def bundled_scenes(keep_paths: Optional[list] = None) -> list[type]:
    """ShaderScene subclasses of the port's example scene files
    (examples/torch/torch_*.py): the scene collection when no file argument
    is given. A source tree has them beside the package; an installed
    wheel bundles examples/ at shaderflow_tpu/resources/examples (setup.py),
    found here by its path, importing nothing of that package.

    `keep_paths`: when given, example dirs that yielded scenes stay on
    sys.path (appended to the list for the caller to remove after launch),
    so a discovered scene that lazily imports a sibling at render time
    resolves the same way it did at discovery time. Without it (standalone
    calls), sys.path is restored immediately."""
    import shaderflow_tpu_torch
    site = Path(shaderflow_tpu_torch.__file__).resolve().parent.parent
    examples = site / "examples" / "torch"
    if not examples.is_dir():
        examples = site / "shaderflow_tpu" / "resources" / "examples" / "torch"
    if not examples.is_dir():
        return []
    scenes: list[type] = []
    seen: set[str] = set()
    parent = str(examples)
    inserted = parent not in sys.path
    if inserted:
        sys.path.insert(0, parent)
    found = False
    try:
        for file in sorted(examples.glob("torch_*.py")):
            try:
                discovered = discover_scenes(file)
            except Exception as error:  # a scene file whose imports fail is skipped
                logger.debug(f"Skipping {file}: {error}")
                continue
            for scene in discovered:
                found = True
                if scene.__name__ not in seen:
                    seen.add(scene.__name__)
                    scenes.append(scene)
    finally:
        if inserted:
            if keep_paths is not None and found:
                keep_paths.append(parent)
            else:
                sys.path.remove(parent)
    return scenes


def main(argv: Optional[list[str]] = None):
    """`python -m shaderflow_tpu_torch [<file.py>] <Scene> main --flags`.

    Without a file argument, the port's example scenes are discovered (so
    `shaderflow-tpu-torch Visualizer main -o out.mp4` works out of the
    box).

    One sys.path policy for both launch forms: the scene file's directory
    (or each example dir that yielded scenes) stays on sys.path for the
    lifetime of launch() — render-time lazy imports resolve exactly like
    discovery-time ones — and is removed when launch returns, so embedding
    processes don't accumulate path state."""
    argv = list(sys.argv[1:] if argv is None else argv)
    inserted: list[str] = []
    try:
        if argv and argv[0].endswith(".py"):
            path = Path(argv.pop(0))
            if not path.exists():
                logger.error(f"Scene file not found: {path}")
                return None
            parent = str(path.resolve().parent)
            if parent not in sys.path:
                sys.path.insert(0, parent)
                inserted.append(parent)
            return launch(discover_scenes(path), argv)
        return launch(bundled_scenes(keep_paths=inserted), argv)
    finally:
        for parent in inserted:
            if parent in sys.path:
                sys.path.remove(parent)
