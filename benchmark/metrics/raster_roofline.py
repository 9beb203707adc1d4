"""raster_roofline: the rasterizer's least time on these inputs (its
pairs' operations at the card's float32 peak or its bytes at the memory
rate, counted by the reference) over its device time, in percent.  Nothing
to read where the trace saw no rasterizer activity."""


def read(ctx):
    steps_s = ctx['raster_s'] / ctx['steps']
    if steps_s <= 0:
        return None
    return ctx['least_raster_s'] / steps_s * 100
