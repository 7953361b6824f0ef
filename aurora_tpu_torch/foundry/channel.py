"""Communication channels that move batches between the serving stack's client and server
(port of ``aurora_tpu/foundry/channel.py``; reference: aurora/foundry/common/channel.py).

Every object is written under a task-scoped name ``<task id>/<name>`` and marked complete by
a ``<name>.finished`` marker once it is whole; a reader polls for the marker once a second
up to a timeout. :class:`LocalFileChannel` works over a shared directory (netCDF through
:meth:`aurora_tpu_torch.Batch.to_netcdf`); :class:`BlobStorageChannel` over an Azure Blob
Storage folder whose URL carries a SAS token (``azure-storage-blob`` is imported when a blob
is moved; the marker's existence is asked with an HTTP HEAD through ``urllib.request``).
"""

from __future__ import annotations

import abc
import logging
import os
import tempfile
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Generator

from aurora_tpu_torch.batch import Batch

__all__ = [
    "CommunicationChannel",
    "LocalFileChannel",
    "BlobStorageChannel",
    "iterate_prediction_files",
    "channel_from_spec",
]

logger = logging.getLogger(__name__)


class CommunicationChannel(abc.ABC):
    """Send/receive batches and raw bytes under task-scoped names, with completion markers
    and polling."""

    def send(self, batch: Batch, uuid: str, name: str) -> None:
        """Send ``batch`` as ``<uuid>/<name>`` and mark it complete."""
        name = f"{uuid}/{name}"
        self._send(batch, name)
        self._mark(name)

    def receive(self, uuid: str, name: str, timeout: int = 120) -> Batch:
        """Blockingly receive the batch stored as ``<uuid>/<name>``."""
        self._wait(f"{uuid}/{name}", timeout)
        return self._receive(f"{uuid}/{name}")

    def write(self, data: bytes, uuid: str, name: str) -> None:
        """Write raw bytes as ``<uuid>/<name>`` and mark them complete."""
        name = f"{uuid}/{name}"
        self._write(data, name)
        self._mark(name)

    def read(self, uuid: str, name: str, timeout: int = 120) -> bytes:
        """Blockingly read raw bytes stored as ``<uuid>/<name>``."""
        self._wait(f"{uuid}/{name}", timeout)
        return self._read(f"{uuid}/{name}")

    def exists(self, uuid: str, name: str) -> bool:
        """Has ``<uuid>/<name>`` been fully written?"""
        return self._is_marked(f"{uuid}/{name}")

    def _wait(self, name: str, timeout: int) -> None:
        start = time.time()
        while not self._is_marked(name):
            if time.time() - start >= timeout:
                raise TimeoutError("File was not marked within the timeout.")
            time.sleep(1)

    @abc.abstractmethod
    def _send(self, batch: Batch, name: str) -> None: ...

    @abc.abstractmethod
    def _receive(self, name: str) -> Batch: ...

    @abc.abstractmethod
    def _write(self, data: bytes, name: str) -> None: ...

    @abc.abstractmethod
    def _read(self, name: str) -> bytes: ...

    @abc.abstractmethod
    def _mark(self, name: str) -> None: ...

    @abc.abstractmethod
    def _is_marked(self, name: str) -> bool: ...

    @abc.abstractmethod
    def to_spec(self) -> str:
        """Serialisable description from which the server can reconstruct the channel."""


class LocalFileChannel(CommunicationChannel):
    """Channel over a shared filesystem directory."""

    def __init__(self, folder: str) -> None:
        self.folder = Path(folder)
        self.folder.mkdir(parents=True, exist_ok=True)

    def to_spec(self) -> str:
        return f"file://{self.folder}"

    def _path(self, name: str) -> Path:
        p = self.folder / name
        p.parent.mkdir(parents=True, exist_ok=True)
        return p

    def _send(self, batch: Batch, name: str) -> None:
        batch.to_netcdf(self._path(name))

    def _receive(self, name: str) -> Batch:
        return Batch.from_netcdf(self._path(name))

    def _write(self, data: bytes, name: str) -> None:
        self._path(name).write_bytes(data)

    def _read(self, name: str) -> bytes:
        return self._path(name).read_bytes()

    def _mark(self, name: str) -> None:
        self._path(f"{name}.finished").write_text("File is available")

    def _is_marked(self, name: str) -> bool:
        return (self.folder / f"{name}.finished").exists()


class BlobStorageChannel(CommunicationChannel):
    """Channel over an Azure Blob Storage folder (the URL must embed a read/write SAS
    token). Moving a blob needs ``azure-storage-blob``."""

    def __init__(self, blob_folder: str) -> None:
        if "?" not in blob_folder:
            raise ValueError("Given URL does not appear to contain a SAS token.")
        self.blob_folder = blob_folder

    def to_spec(self) -> str:
        return self.blob_folder

    def _blob_url(self, name: str) -> str:
        url, _, sas = self.blob_folder.partition("?")
        return f"{url.rstrip('/')}/{name.lstrip('/')}?{sas}"

    def _upload(self, file_path: str, name: str) -> None:
        from azure.storage.blob import BlobClient

        client = BlobClient.from_blob_url(self._blob_url(name))
        with open(file_path, "rb") as f:
            client.upload_blob(f, overwrite=True)

    def _download(self, name: str, file_path: str) -> None:
        from azure.storage.blob import BlobClient

        client = BlobClient.from_blob_url(self._blob_url(name))
        with open(file_path, "wb") as f:
            f.write(client.download_blob().readall())

    def _send(self, batch: Batch, name: str) -> None:
        with tempfile.NamedTemporaryFile(delete=False) as tf:
            pass
        try:
            batch.to_netcdf(tf.name)
            self._upload(tf.name, name)
        finally:
            os.unlink(tf.name)

    def _receive(self, name: str) -> Batch:
        with tempfile.NamedTemporaryFile(delete=False) as tf:
            pass
        try:
            self._download(name, tf.name)
            return Batch.from_netcdf(tf.name)
        finally:
            os.unlink(tf.name)

    def _write(self, data: bytes, name: str) -> None:
        with tempfile.NamedTemporaryFile(delete=False) as tf:
            tf.write(data)
        try:
            self._upload(tf.name, name)
        finally:
            os.unlink(tf.name)

    def _read(self, name: str) -> bytes:
        with tempfile.NamedTemporaryFile(delete=False) as tf:
            pass
        try:
            self._download(name, tf.name)
            with open(tf.name, "rb") as f:
                return f.read()
        finally:
            os.unlink(tf.name)

    def _mark(self, name: str) -> None:
        self._write(b"File is available", f"{name}.finished")

    def _is_marked(self, name: str) -> bool:
        request = urllib.request.Request(self._blob_url(f"{name}.finished"), method="HEAD")
        try:
            with urllib.request.urlopen(request) as res:
                return res.status == 200
        except urllib.error.HTTPError:  # 404 until the marker is written
            return False


def channel_from_spec(spec: str) -> CommunicationChannel:
    """Reconstruct a channel from its ``to_spec`` string."""
    if spec.startswith("file://"):
        return LocalFileChannel(spec[len("file://"):])
    return BlobStorageChannel(spec)


def iterate_prediction_files(name: str, num_steps: int) -> Generator[str, None, None]:
    """Per-step prediction file names: ``prediction-000.nc``, ``prediction-001.nc``, ..."""
    base, ext = os.path.splitext(name)
    for i in range(num_steps):
        yield f"{base}-{i:03d}{ext}"
