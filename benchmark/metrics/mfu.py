"""mfu: the whole step's or request's least time on these inputs (the
rasterizer's operations, and the bytes of every stage: lighting,
transform, rasterizer, loss and Adam) over its time in the traced window,
in percent of the card's peak."""


def read(ctx):
    return ctx['least_step_s'] / (ctx['window_s'] / ctx['steps']) * 100
