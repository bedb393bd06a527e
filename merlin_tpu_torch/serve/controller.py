"""Serving controller (counterpart of ``merlin_tpu/serve/controller.py``,
on stdlib ``http.server``).

Endpoints:
  POST /register_worker          {worker_name, check_heart_beat, worker_status}
  POST /receive_heart_beat       {worker_name, queue_length} -> {exist}
  POST /refresh_all_workers
  POST /list_models              -> {models}
  POST /get_worker_address       {model} -> {address}
  POST /worker_generate_stream   relay: picks a worker, streams its chunks

Dispatch: LOTTERY (speed-weighted random, drawn from ``np.random``) or
SHORTEST_QUEUE (queue length over speed). Workers expire after 30 s without
a heartbeat. Unlike the JAX relay, which reads the worker in 4096-byte
blocks and so holds a streamed answer back, the relay forwards each piece
as it arrives.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

from merlin_tpu_torch.serve.protocol import (
    CONTROLLER_HEART_BEAT_EXPIRATION, ErrorCode, http_json, pack_chunk)
from merlin_tpu_torch.utils.logging import setup_logger

logger = setup_logger(name="merlin_tpu_torch.controller")


class DispatchMethod(enum.Enum):
    LOTTERY = "lottery"
    SHORTEST_QUEUE = "shortest_queue"

    @classmethod
    def from_str(cls, name: str) -> "DispatchMethod":
        return {"lottery": cls.LOTTERY,
                "shortest_queue": cls.SHORTEST_QUEUE}[name]


@dataclasses.dataclass
class WorkerInfo:
    model_names: List[str]
    speed: float
    queue_length: int
    check_heart_beat: bool
    last_heart_beat: float


class Controller:
    def __init__(self, dispatch_method: str = "shortest_queue"):
        self.workers: Dict[str, WorkerInfo] = {}
        self.dispatch_method = DispatchMethod.from_str(dispatch_method)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._expire_thread = threading.Thread(
            target=self._expire_loop, daemon=True)
        self._expire_thread.start()

    # ------------------------------------------------------------------
    def register_worker(self, worker_name: str, check_heart_beat: bool,
                        worker_status: Optional[Dict]) -> bool:
        if worker_status is None:
            worker_status = self._get_worker_status(worker_name)
        if worker_status is None:
            return False
        with self._lock:
            self.workers[worker_name] = WorkerInfo(
                model_names=worker_status["model_names"],
                speed=worker_status.get("speed", 1.0),
                queue_length=worker_status.get("queue_length", 0),
                check_heart_beat=check_heart_beat,
                last_heart_beat=time.time())
        logger.info("registered worker %s: %s", worker_name, worker_status)
        return True

    def _get_worker_status(self, worker_name: str) -> Optional[Dict]:
        try:
            return http_json("POST", worker_name + "/worker_get_status")
        except Exception as e:
            logger.warning("get_status failed for %s: %s", worker_name, e)
            return None

    def refresh_all_workers(self):
        with self._lock:
            old = dict(self.workers)
            self.workers = {}
        for name, info in old.items():
            if not self.register_worker(name, info.check_heart_beat, None):
                logger.info("removed stale worker %s", name)

    def receive_heart_beat(self, worker_name: str, queue_length: int) -> bool:
        with self._lock:
            if worker_name not in self.workers:
                return False  # worker should re-register (model_worker.py:101)
            self.workers[worker_name].queue_length = queue_length
            self.workers[worker_name].last_heart_beat = time.time()
            return True

    def _expire_loop(self):
        while not self._stop.wait(CONTROLLER_HEART_BEAT_EXPIRATION):
            self.remove_stale_workers()

    def remove_stale_workers(self):
        expire = time.time() - CONTROLLER_HEART_BEAT_EXPIRATION
        with self._lock:
            dead = [n for n, w in self.workers.items()
                    if w.check_heart_beat and w.last_heart_beat < expire]
            for name in dead:
                del self.workers[name]
        for name in dead:
            logger.info("expired worker %s", name)

    # ------------------------------------------------------------------
    def list_models(self) -> List[str]:
        with self._lock:
            names = set()
            for w in self.workers.values():
                names.update(w.model_names)
            return sorted(names)

    def get_worker_address(self, model_name: str) -> str:
        with self._lock:
            cands = [(n, w) for n, w in self.workers.items()
                     if model_name in w.model_names]
            if not cands:
                return ""
            if self.dispatch_method == DispatchMethod.LOTTERY:
                speeds = np.asarray([w.speed for _, w in cands], np.float32)
                total = float(speeds.sum())
                if total <= 0:
                    return ""
                idx = int(np.random.choice(len(cands), p=speeds / total))
                return cands[idx][0]
            # shortest queue, normalized by speed (controller.py:150-165)
            qlens = [w.queue_length / max(w.speed, 1e-4) for _, w in cands]
            idx = int(np.argmin(qlens))
            name, w = cands[idx]
            w.queue_length += 1
            return name

    def worker_generate_stream(self, params: Dict):
        """Relay generator yielding \\0-delimited chunks (controller.py:193-215)."""
        address = self.get_worker_address(params.get("model", ""))
        if not address:
            yield pack_chunk({"text": "", "error_code": ErrorCode.WORKER_ABSENT})
            return
        import urllib.request

        try:
            req = urllib.request.Request(
                address + "/worker_generate_stream",
                data=json.dumps(params).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                while True:
                    # read1: forward what has arrived; read(n) would
                    # hold a streamed answer back until n bytes came
                    data = resp.read1(4096)
                    if not data:
                        break
                    yield data
        except TimeoutError:
            yield pack_chunk({"text": "", "error_code": ErrorCode.TIMEOUT})
        except Exception as e:
            logger.warning("relay failed: %s", e)
            yield pack_chunk({"text": "", "error_code": ErrorCode.WORKER_ERROR})

    def stop(self):
        self._stop.set()


def make_handler(controller: Controller):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _json(self, payload: Dict, code: int = 200):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read(self) -> Dict:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_POST(self):
            body = self._read()
            if self.path == "/register_worker":
                ok = controller.register_worker(
                    body["worker_name"], body.get("check_heart_beat", True),
                    body.get("worker_status"))
                self._json({"exist": ok})
            elif self.path == "/receive_heart_beat":
                ok = controller.receive_heart_beat(
                    body["worker_name"], body.get("queue_length", 0))
                self._json({"exist": ok})
            elif self.path == "/refresh_all_workers":
                controller.refresh_all_workers()
                self._json({})
            elif self.path == "/list_models":
                self._json({"models": controller.list_models()})
            elif self.path == "/get_worker_address":
                self._json({"address":
                            controller.get_worker_address(body.get("model", ""))})
            elif self.path == "/worker_generate_stream":
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.end_headers()
                for chunk in controller.worker_generate_stream(body):
                    self.wfile.write(chunk)
                    self.wfile.flush()
            else:
                self._json({"error": "unknown endpoint"}, 404)

    return Handler


def serve(host: str = "0.0.0.0", port: int = 21001,
          dispatch_method: str = "shortest_queue") -> ThreadingHTTPServer:
    controller = Controller(dispatch_method)
    server = ThreadingHTTPServer((host, port), make_handler(controller))
    server.controller = controller
    return server


def main():
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=21001)
    p.add_argument("--dispatch-method", default="shortest_queue",
                   choices=["lottery", "shortest_queue"])
    args = p.parse_args()
    server = serve(args.host, args.port, args.dispatch_method)
    logger.info("controller listening on %s:%d", args.host, args.port)
    server.serve_forever()


if __name__ == "__main__":
    main()
