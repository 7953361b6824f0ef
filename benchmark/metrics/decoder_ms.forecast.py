"""Device time of the kernels launched inside the decoder's span, per step."""


def read(r):
    return 1e3 * r.span_s["decoder"] / r.steps if r.steps else None
