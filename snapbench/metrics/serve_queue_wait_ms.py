"""Mean ms a request waits in the service's queue: the program's counters
``serve.queue_wait_ns`` over ``serve.dispatched`` (entering the queue to
dispatch, on the server's own clock) in the window (force service
layer)."""

from snapbench import program


def read(rec):
    c = program.counts(rec, 'serve.step')
    if not c or not c.get('serve.dispatched'):
        return None
    return c['serve.queue_wait_ns'] / c['serve.dispatched'] * 1e-6
