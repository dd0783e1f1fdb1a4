"""Host milliseconds a frame in RenderEngine.flush (pack, upload, preludes,
the fragment's and the tail's enqueue), over every frame the window
stepped."""


# Spans this metric reads: label -> (module, owner, attribute)
SPANS = {"scene.step": ("shaderflow_tpu_torch.scene", "ShaderScene", "next"),
         "engine.flush": ("shaderflow_tpu_torch.engine", "RenderEngine", "flush")}


def read(trace):
    frames = len(trace.host.get("scene.step", ()))
    return 1e3 * trace.host_seconds("engine.flush") / frames if frames else None
