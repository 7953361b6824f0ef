"""Client API: submit a roll-out request to a scoring endpoint and stream the predictions
back (port of ``aurora_tpu/foundry/client.py``; reference: aurora/foundry/client/api.py and
client/foundry.py).

Requests go through ``urllib.request`` with the JAX package's headers and envelope.
"""

from __future__ import annotations

import json
import logging
import urllib.error
import urllib.request
from typing import Generator

from aurora_tpu_torch.batch import Batch
from aurora_tpu_torch.foundry.channel import CommunicationChannel, iterate_prediction_files
from aurora_tpu_torch.foundry.models import models

__all__ = ["FoundryClient", "SubmissionError", "submit"]

logger = logging.getLogger(__name__)


class SubmissionError(Exception):
    """The submission could not be completed."""


class FoundryClient:
    """Thin HTTP client for the scoring endpoint (bearer-token auth, the Foundry
    ``{"input_data": {"data": json}}`` envelope). A response whose status is not 2xx raises
    ``urllib.error.HTTPError``."""

    def __init__(self, endpoint: str, token: str) -> None:
        self.endpoint = endpoint
        self.token = token

    def _req(self, data: dict) -> dict:
        request = urllib.request.Request(
            self.endpoint,
            data=json.dumps({"input_data": {"data": json.dumps(data)}}).encode(),
            headers={
                "Authorization": f"Bearer {self.token}",
                "Content-Type": "application/json",
            },
            method="POST",
        )
        try:
            with urllib.request.urlopen(request) as response:
                return json.loads(response.read())
        except urllib.error.HTTPError as e:
            logger.error(e.read().decode(errors="replace"))
            raise

    def submit_task(self, data: dict) -> dict:
        return self._req({"type": "submission", "msg": data})

    def get_progress(self, task_id: str) -> dict:
        return self._req({"type": "task_info", "msg": {"task_id": task_id}})


def submit(
    batch: Batch,
    model_name: str,
    num_steps: int,
    channel: CommunicationChannel,
    foundry_client: FoundryClient,
) -> Generator[Batch, None, None]:
    """Submit an initial condition and yield the ``num_steps`` predictions.

    Protocol: create the task at the endpoint, upload the initial condition over the
    channel, poll progress (verifying the server's write-acknowledgement once the task
    is submitted), then stream back the per-step prediction files.
    """
    if model_name not in models:
        raise KeyError(f"Model `{model_name}` is not a valid model.")

    response = foundry_client.submit_task(
        {
            "model_name": model_name,
            "num_steps": num_steps,
            "data_folder_uri": channel.to_spec(),
        }
    )
    task_id = response.get("task_id")
    if not task_id:
        raise SubmissionError("Failed to create task.")
    logger.info(f"Created task `{task_id}` at endpoint.")

    logger.info("Uploading initial condition.")
    channel.send(batch, task_id, "input.nc")

    previous_status = "No status"
    previous_progress = 0
    ack_read = False

    while True:
        info = foundry_client.get_progress(task_id)

        if info["submitted"] and not ack_read:
            try:
                channel.read(task_id, "input.nc.ack", timeout=120)
                ack_read = True
            except TimeoutError as e:
                raise SubmissionError(
                    "Could not read acknowledgement of initial condition even though "
                    "the task was submitted. Check connectivity/credentials on both "
                    "sides of the channel."
                ) from e

        if info["status"] != previous_status:
            logger.info(f"Task status update: {info['status']}")
            previous_status = info["status"]
        if info["progress_percentage"] > previous_progress:
            logger.info(f"Task progress update: {info['progress_percentage']}%.")
            previous_progress = info["progress_percentage"]

        if info["completed"]:
            if info["success"]:
                logger.info("Task has been successfully completed!")
                break
            raise SubmissionError(f"Task failed: {info['status']}")

    logger.info("Retrieving predictions.")
    for prediction_name in iterate_prediction_files("prediction.nc", num_steps):
        yield channel.receive(task_id, prediction_name)
    logger.info("All predictions have been retrieved.")
