"""syncs: the host synchronisations a step or request made in the
program (profiler trace; a count): the runtime calls that wait for the
card (``SYNC_CALLS``) that start on the stepping thread inside a ``jr.*``
span, or on another thread (the autograd engine's) inside a
``bench.step`` range.  A frames request's closing ``synchronize`` lies
outside ``jr.render_mesh`` and is not counted.  Nothing to read where the
program carries no ``jr.render_mesh`` span."""
import bisect

from benchmark.harness.trace import _merge

SYNC_CALLS = ('cudaStreamSynchronize', 'cudaDeviceSynchronize', 'cudaEventSynchronize',
              'cudaMemcpy')


def _inside(merged, t) -> bool:
    i = bisect.bisect_right(merged, [t, float('inf')]) - 1
    return i >= 0 and t <= merged[i][1]


def sync_calls(tr):
    """The host microseconds of each such call in the window of ``tr`` (a
    ``harness.trace.Trace``), or None where it holds no ``jr.render_mesh``
    range."""
    spans = [e for e in tr.host if e.get('cat') == 'user_annotation'
             and e['name'].startswith('jr.') and e['ts'] >= tr.t0]
    if not any(e['name'] == 'jr.render_mesh' for e in spans):
        return None
    program = _merge([e['ts'], e['ts'] + e['dur']] for e in spans
                     if (e['pid'], e['tid']) == tr.main)
    steps = _merge([e['ts'], e['ts'] + e['dur']] for e in tr.steps)
    return [e['dur'] for e in tr.host
            if e.get('cat') == 'cuda_runtime' and e['name'] in SYNC_CALLS and e['ts'] >= tr.t0
            and _inside(program if (e['pid'], e['tid']) == tr.main else steps, e['ts'])]


def read(ctx):
    calls = sync_calls(ctx['trace'])
    return None if calls is None else len(calls) / ctx['steps']
