"""The teacher trunk's share of its roofline, in percent: the least time
of the work of the program's profiler range "trunk" (its int8 convs, each
at the larger of its operations at 1979 TOP/s and its bytes at 3.35 TB/s,
and its quantise passes' bytes; `ovbench/work.py`), over the range's
device ms a step."""

from ovbench import work


def read(ctx):
    ms = (ctx.trace or {}).get("ranges", {}).get("trunk")
    if not ms or not ctx.cfg.get("teacher", {}).get("enabled"):
        return None
    return 100.0 * work.trunk_seconds(ctx.cfg) * 1e3 / ms
