"""K2 (``csrc/bucket_maxima.cu``, bucket maxima over the bf16 shadow):
percent of its bound reached over the traced stretch. The bound of a
launch is the shadow's read (``roofline/counts.py``); the batch of a
launch inside a coalesced dispatch is not known from outside, so it is
counted as one query, which never overstates the share."""

from portbench.roofline import counts


def read(ctx):
    t = ctx.trace
    if t is None or not t.count("K2"):
        return None
    cfg = ctx.cell.cfg
    bound = counts.bucket_maxima_bf16(cfg["rows"], cfg["dim"]).bound_s(counts.peaks())
    return 100.0 * bound * t.count("K2") / t.seconds("K2")
