"""GAT's attention at its least time, over the device time of the kernels
that do it, in %: on the hybrid layout the fused passes (``work.attend``)
over K4-K6; on the COO layout the score maxima (``work.segment_max``)
over K2."""

from benchmark.readers import roofline


def read(ctx):
    return roofline(ctx, {"attend", "segment_max"}, ["K2", "K4", "K5", "K6"])
