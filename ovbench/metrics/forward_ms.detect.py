"""Device ms a request of the detector's eval-mode forward: the kernels
launched inside a range the benchmark puts around `Detector.eval_step`,
over eager requests profiled after the window."""


def read(ctx):
    return (ctx.trace or {}).get("ranges", {}).get("bench.forward")
