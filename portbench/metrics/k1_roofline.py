"""K1 (``csrc/topk.cu``): percent of its bound reached over the traced
stretch, each launch's bound from its request's batch and the rows in
its scope (``roofline/scans.py``)."""

from portbench.roofline.scans import scan_roofline


def read(ctx):
    return scan_roofline(ctx, "K1")
