"""Device time per step of K2 (``window_attention``, with the attention tail) inside the
backbone: the program's spans ``aurora:k.window_attention`` nested in ``aurora:backbone``."""

from benchmark import spans


def read(r):
    return spans.ms(r, "aurora:k.window_attention", "aurora:backbone")
