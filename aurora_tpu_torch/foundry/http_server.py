"""The serving stack's HTTP endpoint (port of ``aurora_tpu/foundry/http_server.py``).

The reference deploys its server as an MLflow pyfunc behind an Azure AI Foundry scoring
endpoint; this module gives the same wire surface (``POST /score`` with the Foundry
``{"input_data": {"data": "<json>"}}`` envelope and bearer-token auth) as a standard-library
``ThreadingHTTPServer`` on 127.0.0.1, so the whole client/server loop runs over a real socket.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from aurora_tpu_torch.foundry.server import InferenceServer

__all__ = ["serve", "ServerHandle"]

logger = logging.getLogger(__name__)


class ServerHandle:
    """A running HTTP serving endpoint; use as a context manager or call close()."""

    def __init__(self, httpd: ThreadingHTTPServer, inference: InferenceServer, thread):
        self._httpd = httpd
        self._inference = inference
        self._thread = thread
        self.port = httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}/score"

    @property
    def inference(self) -> InferenceServer:
        """The server behind the endpoint (its tasks, their timings)."""
        return self._inference

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)
        self._inference.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def serve(port: int = 0, token: str | None = None, device=None) -> ServerHandle:
    """Start the scoring endpoint on ``port`` (0 = ephemeral). Returns a handle. Its models
    run on ``device``: the card unless ``device="cpu"`` is given (without a card and without
    that it raises)."""
    inference = InferenceServer(device=device)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route to logging, not stderr
            logger.debug("http: " + fmt, *args)

        def do_POST(self):
            if token is not None:
                auth = self.headers.get("Authorization", "")
                if auth != f"Bearer {token}":
                    self.send_response(401)
                    self.end_headers()
                    return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                envelope = json.loads(self.rfile.read(length))
                data = json.loads(envelope["input_data"]["data"])
                result = inference.handle(data)
                body = json.dumps(result).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except Exception as e:  # surface errors as 500 + message
                logger.exception("request failed")
                body = json.dumps({"error": str(e)}).encode()
                self.send_response(500)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

    httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    logger.info(f"serving on port {httpd.server_address[1]}")
    return ServerHandle(httpd, inference, thread)
