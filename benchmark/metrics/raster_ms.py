"""raster_ms: device milliseconds a step or request launched inside the
rasterizer's call and, in a fit cell, its autograd backward node
(profiler trace)."""


def read(ctx):
    return ctx['raster_s'] / ctx['steps'] * 1e3
