"""sync_wait_ms: the host milliseconds a step or request spent inside the
synchronisations that ``syncs`` counts (profiler trace): how long the
program held its own enqueue back to wait for the card.  Nothing to read
where the program carries no ``jr.render_mesh`` span."""
from benchmark.metrics.syncs import sync_calls


def read(ctx):
    calls = sync_calls(ctx['trace'])
    return None if calls is None else sum(calls) / ctx['steps'] / 1e3
