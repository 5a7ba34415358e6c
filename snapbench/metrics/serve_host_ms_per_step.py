"""Host ms a service step: the harness's span around each ``step`` less the
device's busy time inside it, the mean over the window's steps (force
service layer: ``launch/serve_forces``, ``launch/request_queue``)."""


def read(rec):
    spans = rec.spans_in_window('step')
    if not spans or not rec.count():
        return None
    host = [(e - s) - rec.busy_within(s, e) for s, e in spans]
    return sum(host) / len(host) * 1e-6
