"""``wall_rounds_per_s`` (layer: step): the untraced window's rounds over
its wall time, per layer in a cell whose wall-clock rate drifts with the
speed of the machine's host cores between processes, so that its
end-to-end metric is the card's time a round."""


def read(r):
    return r.rate
