"""The whole LoRA train step's share of the configuration's peak: the forward's products plus
the backward's that the input and adapter gradients need (``benchmark/count``), times the
steps in the traced window, over the window and the peak."""


def read(r):
    if not r.steps:
        return None
    work = r.steps * (sum(r.counts["forward"].values()) + r.counts["backward"])
    return 100.0 * work / (r.window_s * r.counts["peak_flops"])
