"""The whole forecast step's share of the configuration's peak: the products of every step
in the traced window (counted from the shapes, ``benchmark/count``) over the window and the
peak."""


def read(r):
    if not r.steps:
        return None
    work = r.steps * sum(r.counts["forward"].values())
    return 100.0 * work / (r.window_s * r.counts["peak_flops"])
