"""``mfu.device`` (layer: step): the whole round's share of the cards' peak
over the time the card is busy, in a cell whose end-to-end metric is
``device_ms_per_round``: FLOPs a round (the reference's,
``modes/<mode>.py:flops_per_round``) over the traced slice's device-busy
seconds a round (rank 0's card), over the dense peak of the configuration's
compute dtype (``roofline.PEAK_FLOPS``)."""

from perfbench import roofline


def read(r):
    busy_s = r.summary["busy_ns"] / 1e9 / r.rounds
    if not busy_s:
        return None
    flops = r.mode.flops_per_round(r.cfg, r.traffic) / r.world
    return 100.0 * flops / busy_s / roofline.PEAK_FLOPS[r.cfg["compute_dtype"]]
