"""device_idle_share: share of the traced window in which no operation ran
on the device, in % (the union of the device trace's intervals)."""


def read(ctx):
    if ctx.busy_s is None or not ctx.ops or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
