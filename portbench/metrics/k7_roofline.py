"""K7 (``csrc/topk.cu``, an int8 store's row-masked scan): percent of its
bound reached over the traced stretch, each launch's bound from its
request's batch and the rows in its scope (``roofline/scans_int8.py``)."""

from portbench.roofline.scans_int8 import scan_int8_roofline


def read(ctx):
    return scan_int8_roofline(ctx, "K7")
