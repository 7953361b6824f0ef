"""Device time per step of the operations launched outside the encoder, backbone and decoder
spans on the window's thread: normalisation, the history's concatenation, the host copies."""


def read(r):
    return 1e3 * r.outside_s / r.steps if r.steps else None
