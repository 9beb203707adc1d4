"""host_ms: the host's milliseconds from the call of a fit step, or of a
request's enqueue, to its return, with no synchronise of the harness's
inside (a request's closing synchronize is left out), each started on an
idle card: the mean over the traced run's untraced host calls (host
clock).  The program's own host reads inside the call stay in it."""


def read(ctx):
    return sum(ctx['host_s']) / len(ctx['host_s']) * 1e3
