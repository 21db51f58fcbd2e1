"""``device_idle_pct``: the share of the traced window in which no device
operation ran (the complement of the union of the trace's kernel, memcpy and
memset intervals), in %."""


def read(r):
    tl = r.timeline
    if tl is None or tl.window_s <= 0 or tl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
