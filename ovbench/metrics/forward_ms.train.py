"""Device ms a step of the detector's training forward (models/): the kernels launched inside the
program's profiler range "forward", over eager steps profiled after the
window (a graph replay carries no ranges)."""


def read(ctx):
    return (ctx.trace or {}).get("ranges", {}).get("forward")
