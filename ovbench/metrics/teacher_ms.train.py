"""Device ms a step of the frozen RegionCLIP teacher: the kernels launched inside the
program's profiler range "teacher", over eager steps profiled after the
window (a graph replay carries no ranges)."""


def read(ctx):
    return (ctx.trace or {}).get("ranges", {}).get("teacher")
