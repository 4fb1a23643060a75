"""The whole training step's share of the chip's peak: the step's products
counted from the configuration's shapes at their precisions' published
peaks (`ovbench/work.py`), over the measured time a step of a traced
stretch of graphed steps."""


def read(ctx):
    t, least = ctx.trace, ctx.out.get("step_seconds_at_peak")
    if not t or not least or t["steps"] <= 0:
        return None
    return least / (t["window_s"] / t["steps"])
