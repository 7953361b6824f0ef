"""Device time per train step of K3's gradient: the program's spans
``aurora:grad.mlp_adaln_residual`` (the plain math recomputed and differentiated, all
chunks)."""

from benchmark import spans


def read(r):
    return spans.ms(r, "aurora:grad.mlp_adaln_residual")
