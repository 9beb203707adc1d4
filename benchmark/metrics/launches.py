"""launches: the kernels, copies and fills the device ran a step or
request in the traced window (profiler trace; a count)."""


def read(ctx):
    return ctx['activities'] / ctx['steps']
