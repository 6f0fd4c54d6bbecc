"""``launches_per_round`` (layer: round): device kernel, memcpy and memset
events in the traced slice (rank 0's card), over the slice's rounds."""


def read(r):
    return r.summary["launches"] / r.rounds if r.summary["launches"] else None
