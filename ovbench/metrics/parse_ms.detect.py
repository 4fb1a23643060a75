"""Device ms a request of the parse (the empty-box test and NMS): the
kernels launched inside a range the benchmark puts around
`eval.parse.parse_predictions`, over eager requests profiled after the
window."""


def read(ctx):
    return (ctx.trace or {}).get("ranges", {}).get("bench.parse")
