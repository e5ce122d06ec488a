"""SAGE's mean aggregations (``work.segment_sum``: the train forward's, the
backward's over the transpose and the val forward's) at their least time,
over the device time of K1, which carries every one of them, in %."""

from benchmark.readers import roofline


def read(ctx):
    return roofline(ctx, {"segment_sum"}, ["K1"])
