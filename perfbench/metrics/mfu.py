"""``mfu`` (layer: step): the whole round's share of the cards' peak.

FLOPs a round (the reference's, ``modes/<mode>.py:flops_per_round`` from
the configuration's frozen per-sample counts) times the untraced window's
rounds/s, over the dense peak of the configuration's compute dtype times
the cards the cell uses (``roofline.PEAK_FLOPS``).
"""

from perfbench import roofline


def read(r):
    flops = r.mode.flops_per_round(r.cfg, r.traffic)
    peak = roofline.PEAK_FLOPS[r.cfg["compute_dtype"]] * r.world
    return 100.0 * flops * r.rate / peak
