"""Device time per step of K3 (``mlp_adaln_residual``) inside the backbone: the program's
spans ``aurora:k.mlp_adaln_residual`` nested in ``aurora:backbone``, each the whole launch
function (operand casts included)."""

from benchmark import spans


def read(r):
    return spans.ms(r, "aurora:k.mlp_adaln_residual", "aurora:backbone")
