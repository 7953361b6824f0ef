"""The server's model registry (port of ``aurora_tpu/foundry/models.py``; reference:
aurora/foundry/common/model.py).

Each entry pairs one of the port's model facades with a checkpoint artifact registered in
:data:`ARTIFACTS`; :meth:`ServedModel.run` is the port's :func:`aurora_tpu_torch.rollout`,
each prediction moved to the host as it is made. A served model runs on the card unless it
is built with ``device="cpu"``; without a card and without that it raises. It runs its
facade's default config, as the JAX package's registry builds it
(``aurora_tpu/foundry/models.py:34-35``): float32 all through for every released facade, on
the card's float32 kernels.
"""

from __future__ import annotations

import logging
from typing import Generator

from aurora_tpu_torch.batch import Batch
from aurora_tpu_torch.model import aurora as aurora_models
from aurora_tpu_torch.rollout import rollout

__all__ = ["ServedModel", "models", "ARTIFACTS"]

logger = logging.getLogger(__name__)

# ``<name, artifact_path>`` entries pointing at checkpoint files on the server: a reference
# ``.ckpt`` file, or a file of the port's ``checkpoint.save_params``.
ARTIFACTS: dict[str, str] = {}


class ServedModel:
    """A named model + checkpoint that can serve roll-out requests."""

    name: str
    model_cls: type

    def __init__(self, device=None):
        self.model = self.model_cls(device=device, seed=None)
        self._load_params()

    def _load_params(self):
        """Load the registered artifact into ``self.model`` and return the model: a ``.ckpt``
        through the reference checkpoint converter, anything else as a ``save_params`` file;
        under ``autocast`` the backbone is then stored in bf16."""
        path = ARTIFACTS.get(self.name)
        if path is None:
            raise KeyError(f"No artifact registered for `{self.name}`.")
        if path.endswith(".ckpt"):
            self.model.load_checkpoint_local(path)
        else:
            from aurora_tpu_torch.checkpoint import restore_params

            restore_params(path, like=self.model)
        if self.model.cfg.autocast:
            # The backbone computes in bf16 under autocast, so bf16 storage gives the same
            # results with half its weight memory.
            aurora_models.cast_backbone_params(self.model)
        return self.model

    def run(self, batch: Batch, num_steps: int) -> Generator[Batch, None, None]:
        """Run the roll-out, yielding host-resident predictions."""
        for pred in rollout(self.model, batch, steps=num_steps):
            yield pred.to_numpy()


def _served(name: str, model_cls) -> type[ServedModel]:
    return type(
        f"Served_{model_cls.__name__}", (ServedModel,), {"name": name, "model_cls": model_cls}
    )


models: dict[str, type[ServedModel]] = {
    "aurora-0.25-finetuned": _served("aurora-0.25-finetuned", aurora_models.Aurora),
    "aurora-0.25-pretrained": _served("aurora-0.25-pretrained", aurora_models.AuroraPretrained),
    "aurora-0.25-small-pretrained": _served(
        "aurora-0.25-small-pretrained", aurora_models.AuroraSmallPretrained
    ),
    "aurora-0.25-12h-pretrained": _served(
        "aurora-0.25-12h-pretrained", aurora_models.Aurora12hPretrained
    ),
    "aurora-0.1-finetuned": _served("aurora-0.1-finetuned", aurora_models.AuroraHighRes),
    "aurora-0.4-air-pollution": _served(
        "aurora-0.4-air-pollution", aurora_models.AuroraAirPollution
    ),
    "aurora-0.25-wave": _served("aurora-0.25-wave", aurora_models.AuroraWave),
}
"""All served models by name (the reference's seven variants)."""
