"""Host milliseconds a frame in ShaderScene.next (module updates and the
uniform capture), over every frame the window stepped."""


# Spans this metric reads: label -> (module, owner, attribute)
SPANS = {"scene.step": ("shaderflow_tpu_torch.scene", "ShaderScene", "next")}


def read(trace):
    steps = len(trace.host.get("scene.step", ()))
    return 1e3 * trace.host_seconds("scene.step") / steps if steps else None
