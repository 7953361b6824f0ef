"""Device time per train step of K2's gradient: the program's spans
``aurora:grad.window_attention`` (the plain math recomputed and differentiated, all
chunks)."""

from benchmark import spans


def read(r):
    return spans.ms(r, "aurora:grad.window_attention")
