"""Device time of the kernels launched inside the encoder's span, per step."""


def read(r):
    return 1e3 * r.span_s["encoder"] / r.steps if r.steps else None
