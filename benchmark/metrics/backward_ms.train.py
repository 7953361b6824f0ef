"""Device time per step of the operations launched by the autograd engine's threads (the
backward)."""


def read(r):
    return 1e3 * r.other_thread_s / r.steps if r.steps else None
