"""kernel_ms: device milliseconds a step or request launched inside the
program's ``jr.kernel.*`` spans, on any thread (profiler trace): the hand
kernels alone, each launched by ``cuda_impl._run``.  ``raster_ms`` less
``prep_ms`` and ``kernel_ms`` is the rasterizer's PyTorch glue.  Nothing to
read where the program carries no ``jr.render_mesh`` span."""


def read(ctx):
    tr = ctx['trace']
    if not tr.span_device_s(r'jr\.render_mesh')[1]:
        return None
    return tr.span_device_s(r'jr\.kernel\..+')[0] / ctx['steps'] * 1e3
