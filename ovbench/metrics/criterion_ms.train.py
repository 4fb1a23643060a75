"""Device ms a step of the set criterion (losses/criterion.py, the auction, the GIoU): the kernels launched inside the
program's profiler range "criterion", over eager steps profiled after the
window (a graph replay carries no ranges)."""


def read(ctx):
    return (ctx.trace or {}).get("ranges", {}).get("criterion")
