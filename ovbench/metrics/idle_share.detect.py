"""The device's idle share over a stretch of graphed detection requests
after the window: 1 - (the union of the device's operations) / (the
stretch's host wall time, from its first request to its last answer)."""


def read(ctx):
    t = ctx.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
