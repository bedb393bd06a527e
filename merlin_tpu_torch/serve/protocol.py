"""Serving protocol shared by the controller, the workers and the clients
(a copy of ``merlin_tpu/serve/protocol.py``).

JSON request bodies; streamed generation as ``\\0``-delimited JSON chunks;
error codes 1/2/3 for worker error, absent worker and timeout; heartbeats
every 15 s with a 30 s expiry at the controller.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Dict, Iterator, Optional

from merlin_tpu_torch.utils.constants import (
    CONTROLLER_HEART_BEAT_EXPIRATION, WORKER_HEART_BEAT_INTERVAL)

DELIMITER = b"\0"


class ErrorCode(enum.IntEnum):
    WORKER_ERROR = 1
    WORKER_ABSENT = 2
    TIMEOUT = 3


@dataclasses.dataclass
class WorkerStatus:
    model_names: list
    speed: float = 1.0
    queue_length: int = 0


def pack_chunk(payload: Dict) -> bytes:
    return json.dumps(payload, ensure_ascii=False).encode() + DELIMITER


def iter_chunks(stream) -> Iterator[Dict]:
    """Parse a \\0-delimited JSON chunk stream from a file-like object."""
    buf = b""
    while True:
        data = stream.read(4096)
        if not data:
            break
        buf += data
        while DELIMITER in buf:
            chunk, buf = buf.split(DELIMITER, 1)
            if chunk:
                yield json.loads(chunk)


def http_json(method: str, url: str, payload: Optional[Dict] = None,
              timeout: float = 15.0) -> Dict:
    """A small JSON-over-HTTP client on urllib."""
    import urllib.request

    data = json.dumps(payload or {}).encode()
    req = urllib.request.Request(
        url, data=data if method == "POST" else None,
        headers={"Content-Type": "application/json"}, method=method)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        body = resp.read()
    return json.loads(body) if body else {}
