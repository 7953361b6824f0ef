"""Device time per step of the backbone outside its hand-written kernels: the program's span
``aurora:backbone`` less every kernel span (``aurora:k.*``) nested in it. What is left is
the backbone's own PyTorch work (merges and splits, pads and crops, casts, LoRA, the time
MLP) and the device's idle inside the span."""

from benchmark import spans


def read(r):
    return spans.ms_without(r, "aurora:backbone", "aurora:k.*")
