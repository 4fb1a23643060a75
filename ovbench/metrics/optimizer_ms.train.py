"""Device ms a step of the clipped AdamW update: the kernels launched inside the
program's profiler range "optimizer", over eager steps profiled after the
window (a graph replay carries no ranges)."""


def read(ctx):
    return (ctx.trace or {}).get("ranges", {}).get("optimizer")
