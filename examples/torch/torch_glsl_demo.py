"""
GLSL authoring demo on the PyTorch port: scenes whose fragments are GLSL.
Plasma reads a plain `.frag` file (examples/glsl/shaders/plasma.frag,
shared with the JAX package's examples/glsl/glsl_demo.py); Escape is an
inline source whose per-pixel `break` over 256 trips runs as the GLSL
front-end's masked loop. Assign a `.frag` path or GLSL text to
`shader.fragment` and the GLSL front-end (shaderflow_tpu_torch/glsl.py)
runs it on the frame's tensors.

Run:  python -m shaderflow_tpu_torch examples/torch/torch_glsl_demo.py Plasma main \\
          -w 1920 -h 1080 -f 60 -s 2 -t 2 -o out.rgb
      (add --device cpu on a machine without a CUDA card)
"""

from pathlib import Path

from shaderflow_tpu_torch.scene import ShaderScene

SHADERS = Path(__file__).resolve().parent.parent / "glsl" / "shaders"


class Plasma(ShaderScene):
    """Animated plasma rings, authored in GLSL (examples/glsl/shaders/plasma.frag)"""

    def build(self):
        self.shader.fragment = SHADERS / "plasma.frag"


# Escape-time iteration with a per-pixel break (tests/test_glsl.py's
# escape shape): more trips than the front-end unrolls, so it runs as one
# masked loop that stops when every pixel has escaped or at 256 trips
ESCAPE_FRAG = """
void main() {
    vec2 c = vec2(astuv.x * 0.5 - 1.5, astuv.y * 0.2);
    vec2 z = vec2(0);
    int n = 0;
    for (int i = 0; i < 256; i++) {
        if (dot(z, z) > 4.0) break;
        z = vec2(z.x*z.x - z.y*z.y, 2.0*z.x*z.y) + c;
        n++;
    }
    fragColor = vec4(vec3(float(n) / 256.0), 1.0);
}
"""


class Escape(ShaderScene):
    """Escape-time counts from an inline GLSL loop with a per-pixel break"""

    def build(self):
        self.shader.fragment = ESCAPE_FRAG


SCENES = [Plasma, Escape]

if __name__ == "__main__":
    from shaderflow_tpu_torch.cli import launch
    launch(SCENES)
