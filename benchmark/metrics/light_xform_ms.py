"""light_xform_ms: device milliseconds a step or request launched inside
the renderer's lighting and transform calls (their forward; profiler
trace)."""


def read(ctx):
    return (ctx['lighting_s'] + ctx['transform_s']) / ctx['steps'] * 1e3
