"""The epoch's sum aggregations (``work.segment_sum``: GCN's ``Â·X`` and
its transpose; on GAT's COO layout the denominators, the weighted sums and
the gathers' transposes) at their least time, over the device time of the
segment-sum kernels K1 and K3, in %."""

from benchmark.readers import roofline


def read(ctx):
    return roofline(ctx, {"segment_sum"}, ["K1", "K3"])
