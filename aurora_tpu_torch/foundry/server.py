"""The server's task machinery (port of ``aurora_tpu/foundry/server.py``; reference:
aurora/foundry/server/mlflow_wrapper.py).

:class:`InferenceServer` speaks the plain dict-in/dict-out wire protocol of the JAX package:
the task state machine (Unsubmitted → Queued → Running → Completed), lazy submission once
the initial condition appears on the channel (acknowledged by ``input.nc.ack``), per-step
progress, and exceptions captured into the task's status. Tasks run one at a time on a
worker thread, each loading its model's weights anew, as the JAX server does. The MLflow
pyfunc shim is a thin optional layer.
"""

from __future__ import annotations

import json
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict, dataclass
from typing import Optional
from uuid import uuid4

from aurora_tpu_torch.foundry.channel import channel_from_spec, iterate_prediction_files
from aurora_tpu_torch.foundry.models import models
from aurora_tpu_torch.model.aurora import resolve_device

__all__ = ["InferenceServer", "Task", "TaskInfo", "Submission"]

logger = logging.getLogger(__name__)


@dataclass
class Submission:
    data_folder_uri: str
    model_name: str
    num_steps: int


@dataclass
class TaskInfo:
    task_id: str
    completed: bool = False
    progress_percentage: int = 0
    success: Optional[bool] = None
    submitted: bool = False
    status: str = "Unsubmitted"


class Task:
    """One roll-out request: receives the initial condition, runs the model on ``device``,
    streams per-step predictions back over the channel.

    ``timings`` holds the task's host-clock seconds: ``load_s`` (the model built and its
    weights loaded), ``read_s`` (the initial condition received), for each step ``step_s``
    (the prediction made and copied to the host) and ``write_s`` (sent), and ``done_at``
    (``time.perf_counter()`` when the task ended)."""

    def __init__(self, submission: Submission, device=None):
        self.submission = submission
        self.device = device
        self.task_info = TaskInfo(task_id=str(uuid4()))
        self.timings: dict = {"steps": []}

    def __call__(self) -> None:
        info = self.task_info
        info.status = "Running"
        clock = time.perf_counter
        try:
            submission = self.submission
            channel = channel_from_spec(submission.data_folder_uri)
            t0 = clock()
            model = models[submission.model_name](device=self.device)
            t1 = clock()
            batch = channel.receive(info.task_id, "input.nc")
            self.timings.update(load_s=t1 - t0, read_s=clock() - t1)

            logger.info("Running predictions.")
            files = iterate_prediction_files("prediction.nc", submission.num_steps)
            t0 = clock()
            for i, (pred, path) in enumerate(zip(model.run(batch, submission.num_steps), files)):
                t1 = clock()
                channel.send(pred, info.task_id, path)
                t2 = clock()
                self.timings["steps"].append(dict(step_s=t1 - t0, write_s=t2 - t1))
                info.progress_percentage = int(100 * (i + 1) / submission.num_steps)
                t0 = clock()

            info.success = True
            info.status = "Successfully completed"
        except Exception as exc:
            info.success = False
            info.status = f"Exception: {exc}"
        finally:
            self.timings["done_at"] = clock()
            info.completed = True


class InferenceServer:
    """Single-worker async inference server speaking the Foundry wire protocol.

    ``handle`` takes/returns plain dicts:
      * ``{"type": "submission", "msg": {...Submission...}}`` → ``{"task_id": ...}``
      * ``{"type": "task_info", "msg": {"task_id": ...}}`` → TaskInfo dict

    Its models run on ``device``: the card unless ``device="cpu"`` is given; without a card
    and without that it raises here.
    """

    def __init__(self, max_workers: int = 1, device=None):
        self.device = resolve_device(device)
        self.pool = ThreadPoolExecutor(max_workers=max_workers)
        self.tasks: dict[str, Task] = {}

    def handle(self, data: dict) -> dict:
        if data["type"] == "submission":
            task = Task(Submission(**data["msg"]), device=self.device)
            self.tasks[task.task_info.task_id] = task
            return {"task_id": task.task_info.task_id}

        if data["type"] == "task_info":
            task_id = data["msg"].get("task_id")
            if not task_id:
                raise ValueError("Missing `task_id` parameter.")
            if task_id not in self.tasks:
                raise ValueError("Task ID cannot be found.")
            task = self.tasks[task_id]
            info = task.task_info

            if not info.submitted:
                channel = channel_from_spec(task.submission.data_folder_uri)
                if channel.exists(task_id, "input.nc"):
                    logger.info("Initial condition found. Submitting task.")
                    # Acknowledge so the client can verify server-side write access.
                    channel.write(
                        b"Acknowledgement of initial condition", task_id, "input.nc.ack"
                    )
                    info.submitted = True
                    info.status = "Queued"
                    self.pool.submit(task)
                else:
                    time.sleep(3)  # Throttle the client's polling.
            else:
                for _ in range(3):
                    if info.completed:
                        break
                    time.sleep(1)
            return asdict(info)

        raise ValueError(f"Unknown data type: `{data['type']}`.")

    def shutdown(self):
        self.pool.shutdown(wait=False)


def make_mlflow_wrapper():
    """Optional MLflow pyfunc shim (requires ``mlflow``; reference parity:
    aurora/foundry/server/mlflow_wrapper.py:115-180)."""
    import mlflow.pyfunc

    from aurora_tpu_torch.foundry.models import ARTIFACTS

    class AuroraModelWrapper(mlflow.pyfunc.PythonModel):
        def load_context(self, context) -> None:
            self.server = InferenceServer()
            ARTIFACTS.update(context.artifacts)

        def predict(self, context, model_input: dict, params=None) -> dict:
            data = json.loads(model_input["data"].item())
            return self.server.handle(data)

    return AuroraModelWrapper
