"""idle_pct: the share of the traced window in which the device ran no
kernel, copy or fill, in percent (profiler trace)."""


def read(ctx):
    return (1.0 - ctx['busy_s'] / ctx['window_s']) * 100
