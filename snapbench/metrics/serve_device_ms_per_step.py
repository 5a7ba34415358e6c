"""Device ms a service step: the device time of every operation in the
window over the batched evaluations the window ran
(``kernels/ops.make_batched_force_fn``)."""


def read(rec):
    steps = rec.counters.get('device_steps')
    if not steps or not rec.count():
        return None
    return rec.time_s() * 1e3 / steps
