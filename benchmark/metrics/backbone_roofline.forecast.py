"""The backbone's share of its roofline: the least time of its work (its products at the
configuration's peak, or its tokens and weights read and written once at the memory rate,
whichever is longer) over the device time of the kernels launched inside the backbone's
span, per step."""


def read(r):
    spent = r.span_s.get("backbone", 0.0)
    if not r.steps or spent <= 0.0:
        return None
    c = r.counts
    bound = max(c["forward"]["backbone"] / c["peak_flops"], c["backbone_bytes"] / c["hbm"])
    return 100.0 * bound * r.steps / spent
