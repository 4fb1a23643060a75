"""The whole request's share of the chip's peak: the forward's products
counted from the configuration's shapes at the published peak
(`ovbench/work.py`), over the measured time a request of a traced stretch
of graphed requests."""


def read(ctx):
    t, least = ctx.trace, ctx.out.get("request_seconds_at_peak")
    if not t or not least or t["steps"] <= 0:
        return None
    return least / (t["window_s"] / t["steps"])
