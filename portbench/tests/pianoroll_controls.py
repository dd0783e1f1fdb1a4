"""Controls of the piano roll's comparison (PERF.md §2), which the
limit in portbench/configs/pianoroll.json has to refuse. Each is a
context manager that patches what it names while it is open.

Two deliberately wrong ports (CONTROLS), which patch
shaderflow_tpu_torch:

  stale_roll         frame k reads the piano's sequences (roll, keys,
                     channels) of frame k - 1
  float32_stencil    the equal-resolution stencil computed in float32 on
                     K1's bfloat16 planes (the reference rounds its
                     products and sums to bfloat16)

and the precision control, the reference's tail computed in bfloat16,
the precision below the configuration's float32 (the port's bfloat16
tail switch leaves this tail in float32: it reads columns and
coordinates only, which that mode keeps in float32):

  bf16_reference(reference module)
"""

import contextlib


@contextlib.contextmanager
def stale_roll():
    import torch
    from shaderflow_tpu_torch.piano.module import ShaderPiano
    original = ShaderPiano._precompute_sequences

    def shifted(self):
        original(self)
        for texture in (self.keys_texture, self.channel_texture, self.roll_texture):
            sequence = texture.sequence
            texture.set_sequence(torch.cat([sequence[:1], sequence[:-1]]))

    ShaderPiano._precompute_sequences = shifted
    try:
        yield
    finally:
        ShaderPiano._precompute_sequences = original


@contextlib.contextmanager
def float32_stencil():
    import torch
    from shaderflow_tpu_torch.ops import tailfuse
    original = tailfuse.final_equal_resolution

    def stencil(planes, subsample, out=None):
        return original(planes.to(torch.float32), subsample, out=out)

    tailfuse.final_equal_resolution = stencil
    try:
        yield
    finally:
        tailfuse.final_equal_resolution = original


CONTROLS = {"stale_roll": stale_roll, "float32_stencil": float32_stencil}


@contextlib.contextmanager
def bf16_reference(reference):
    import torch
    original = reference.TAIL_DTYPE
    reference.TAIL_DTYPE = torch.bfloat16
    try:
        yield reference
    finally:
        reference.TAIL_DTYPE = original
