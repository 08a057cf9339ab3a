"""The share of the traced window in which no operation ran on the
device (%), from the profiler's trace."""


def read(trace):
    if not trace.device_events or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
