"""Host seconds an export spends in its module prewarm (the whole-clip
spectrogram and waveform precomputes, device work waited for), averaged
over the window's exports."""


# Spans this metric reads: label -> (module, owner, attribute)
SPANS = {"prewarm": ("shaderflow_tpu_torch.scene", "ShaderScene", "_prewarm_modules")}


def read(trace):
    calls = len(trace.host.get("prewarm", ()))
    return trace.host_seconds("prewarm") / calls if calls else None
