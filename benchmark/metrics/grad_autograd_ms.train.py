"""Device time per train step of the backward outside the kernels' gradients: the program's
span ``aurora:train.backward`` less every ``aurora:grad.*`` span nested in it. What is left
is PyTorch's own autograd (LoRA, norms, merges, casts, K1's backward launches) and the
device's idle inside the span."""

from benchmark import spans


def read(r):
    return spans.ms_without(r, "aurora:train.backward", "aurora:grad.*")
