"""The serving stack (port of ``aurora_tpu/foundry``): the client API, the communication
channels, the task server and its HTTP endpoint, and the model registry. Served models run
on the card unless the server is started with ``device="cpu"``."""

from aurora_tpu_torch.foundry.channel import (
    BlobStorageChannel,
    CommunicationChannel,
    LocalFileChannel,
    iterate_prediction_files,
)
from aurora_tpu_torch.foundry.client import FoundryClient, SubmissionError, submit
from aurora_tpu_torch.foundry.server import InferenceServer

__all__ = [
    "BlobStorageChannel",
    "CommunicationChannel",
    "LocalFileChannel",
    "iterate_prediction_files",
    "FoundryClient",
    "SubmissionError",
    "submit",
    "InferenceServer",
]
