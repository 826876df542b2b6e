"""The entry layer's copies: device milliseconds of the host-to-device and
device-to-host copies in the window, per frame completed
(``pipeline.upscale_bgr_batch``'s host-array branch; the staging of
``stream.StreamUpscaler``)."""


def read(ctx):
    copies = ctx.copies(("HtoD", "DtoH"))
    if not copies or not ctx.frames:
        return None
    return sum(d for _, d in copies) / 1e3 / ctx.frames
