"""prep_ms: device milliseconds a step or request launched inside the
program's ``jr.raster.prep`` spans, on any thread (profiler trace): the
rasterizer's prep, SoftRas's rows and tile lists, N3MR's fill_back, rows
and tile lists.  Nothing to read where the program carries no
``jr.render_mesh`` span."""


def read(ctx):
    tr = ctx['trace']
    if not tr.span_device_s(r'jr\.render_mesh')[1]:
        return None
    return tr.span_device_s(r'jr\.raster\.prep')[0] / ctx['steps'] * 1e3
