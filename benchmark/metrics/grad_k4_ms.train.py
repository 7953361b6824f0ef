"""Device time per train step of K4's gradient: the program's spans
``aurora:grad.perceiver_core`` (under LoRA-only training, the decoder's de-aggregation's
input gradient)."""

from benchmark import spans


def read(r):
    return spans.ms(r, "aurora:grad.perceiver_core")
