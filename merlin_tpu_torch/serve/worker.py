"""Model worker (counterpart of ``merlin_tpu/serve/worker.py``, on stdlib
``http.server``).

Holds one model bundle, registers with the controller, heartbeats every
15 s (registering again if the controller forgot it), and serves:

  POST /worker_get_status       -> {model_names, speed, queue_length}
  POST /worker_generate_stream  {prompt, images (base64 list), temperature,
                                 max_new_tokens, stop} -> \\0-delimited
                                 {text, error_code} chunks

Base64 images are decoded with PIL and ``<image>`` placeholders expand to
patch runs. Text-only requests go through the continuous-batching
``ServingEngine`` when ``use_engine`` (the paged kernels on the card);
image requests, and every request without the engine, take
``Generator.stream`` (one chunk per token) or, greedy with
``speculative=k``, the ``SpeculativeGenerator`` (one final chunk). A
semaphore caps the requests in flight; the queue length is what the
controller's shortest-queue dispatch reads.

What differs from the JAX worker: the bundle's model holds its weights;
a speculative request builds its generator for its own token budget (there
is no compile to amortize, so no budget buckets and no generator cache);
``device`` places every generator and the engine (the card by default);
on a CUDA device ``engine_cache_dtype="f32"`` is refused, since the paged
kernels take bf16 or int8 pages only.

    python -m merlin_tpu_torch.serve.worker --controller-address \\
        http://localhost:21001 --port 21002 --engine
"""

from __future__ import annotations

import base64
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from merlin_tpu_torch.eval.runner import EvalConfig, EvalModel
from merlin_tpu_torch.generate.decode import (
    GenerateConfig, Generator, truncate_at_keywords)
from merlin_tpu_torch.generate.speculative import SpeculativeGenerator
from merlin_tpu_torch.serve.protocol import (
    ErrorCode, WORKER_HEART_BEAT_INTERVAL, http_json, pack_chunk)
from merlin_tpu_torch.utils import constants as C
from merlin_tpu_torch.utils.logging import setup_logger

logger = setup_logger(name="merlin_tpu_torch.worker")

CACHE_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8,
                "f32": torch.float32}


class ModelWorker:
    def __init__(self, bundle, *, worker_address: str,
                 controller_address: Optional[str] = None,
                 model_names: Optional[List[str]] = None,
                 limit_concurrency: int = 5,
                 conv_template: str = "v1",
                 use_engine: bool = False, engine_slots: int = 4,
                 engine_max_len: int = 2048, engine_chunk_steps: int = 8,
                 engine_pipeline: int = 1, engine_cache_dtype=None,
                 engine_spec_draft: int = 0,
                 engine_prefill_chunk: int = 0,
                 engine_prefill_chunk_min: int = 0,
                 speculative: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        self.bundle = bundle
        self.device = torch.device(device)
        # prompt-lookup speculative decoding for greedy requests that do
        # not go to the engine; 0 = off. The answer arrives as one chunk
        self.speculative = max(int(speculative), 0)
        self.worker_address = worker_address
        self.controller_address = controller_address
        self.model_names = model_names or ["merlin-tpu"]
        self.semaphore = threading.Semaphore(limit_concurrency)
        self._queue = 0
        self._lock = threading.Lock()
        self._model = EvalModel(bundle, EvalConfig(conv_template=conv_template),
                                device=self.device)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self.engine = None
        if use_engine:
            from merlin_tpu_torch.serve.engine import ServingEngine

            kw = {}
            if engine_cache_dtype:
                kw["cache_dtype"] = CACHE_DTYPES[engine_cache_dtype]
                if self.device.type == "cuda" and \
                        kw["cache_dtype"] == torch.float32:
                    raise ValueError(
                        "engine_cache_dtype='f32' on a CUDA device: the "
                        "paged kernels take bf16 or int8 pages only "
                        "(ROADMAP §B 1)")
            self.engine = ServingEngine(
                bundle.model, num_slots=engine_slots,
                max_len=engine_max_len, chunk_steps=engine_chunk_steps,
                pipeline=engine_pipeline, spec_draft=engine_spec_draft,
                prefill_chunk=engine_prefill_chunk,
                prefill_chunk_min=engine_prefill_chunk_min,
                eos_id=bundle.tokenizer.eos_token_id,
                pad_id=bundle.tokenizer.pad_token_id, device=self.device,
                **kw)
            self._start(self._engine_loop)
        if controller_address:
            self.register()
            self._start(self._heartbeat_loop)

    def _start(self, target):
        thread = threading.Thread(target=target, daemon=True)
        thread.start()
        self._threads.append(thread)

    def _engine_loop(self):
        while not self._stop.is_set():
            try:
                if self.engine.step() == 0:
                    time.sleep(0.005)
            except Exception as e:
                # a dead device path must not silently kill this thread:
                # clients would hang on their queues while heartbeats keep
                # reporting healthy. Fail everything in flight, back off,
                # and keep serving.
                logger.exception("engine step failed; failing in-flight "
                                 "requests")
                try:
                    self.engine.fail_all(f"engine failure: {e}")
                except Exception:
                    logger.exception("engine fail_all also failed")
                time.sleep(1.0)

    # ------------------------------------------------------------------
    def status(self) -> Dict:
        return {"model_names": self.model_names, "speed": 1.0,
                "queue_length": self._queue}

    def register(self):
        try:
            http_json("POST", self.controller_address + "/register_worker", {
                "worker_name": self.worker_address,
                "check_heart_beat": True,
                "worker_status": self.status()})
        except (OSError, ValueError) as e:
            logger.warning("register failed: %s", e)

    def _heartbeat_loop(self):
        while not self._stop.wait(WORKER_HEART_BEAT_INTERVAL):
            try:
                resp = http_json(
                    "POST", self.controller_address + "/receive_heart_beat",
                    {"worker_name": self.worker_address,
                     "queue_length": self._queue})
                if not resp.get("exist"):
                    self.register()  # the controller forgot this worker
            except (OSError, ValueError) as e:
                logger.warning("heartbeat failed: %s", e)

    # ------------------------------------------------------------------
    def _decode_images(self, images_b64: List[str]) -> List:
        from PIL import Image

        return [Image.open(io.BytesIO(base64.b64decode(data))).convert("RGB")
                for data in images_b64 or []]

    def _engine_stream(self, ids, max_new, temperature, stop):
        token_q: "queue.Queue" = queue.Queue()
        self.engine.submit(ids[0], max_new_tokens=max_new,
                           temperature=temperature,
                           emit=lambda t, d: token_q.put((t, d)))
        tok = self.bundle.tokenizer
        collected = []
        while True:
            t, done = token_q.get(timeout=600)
            if t < 0:  # the engine's error sentinel (see Request.emit)
                yield pack_chunk({"text": "request rejected by engine",
                                  "error_code": ErrorCode.WORKER_ERROR})
                return
            collected.append(int(t))
            out_text = tok.decode(collected, skip_special_tokens=True)
            hit = stop and stop in out_text
            out_text = truncate_at_keywords(out_text, [stop])
            yield pack_chunk({"text": out_text, "error_code": 0})
            if done or hit:
                return

    def _speculative_text(self, ids, images, max_new, stop) -> str:
        tok = self.bundle.tokenizer
        # a single-token stop keyword stops inside the loop; longer ones
        # cut the text afterwards
        stop_ids = ()
        if stop:
            enc = tok(stop, add_special_tokens=False)["input_ids"]
            enc = enc[0] if enc and isinstance(enc[0], list) else enc
            if len(enc) == 1 and enc[0] != tok.eos_token_id:
                stop_ids = (int(enc[0]),)
        spec = SpeculativeGenerator(
            self.bundle.model,
            GenerateConfig(max_new_tokens=max_new, do_sample=False,
                           eos_id=tok.eos_token_id, pad_id=tok.pad_token_id,
                           stop_token_ids=stop_ids),
            draft_len=self.speculative, device=self.device)
        out, _, gen_len = spec(ids, images=images)
        toks = [int(t) for t in out[0][:int(gen_len[0])]]
        return truncate_at_keywords(
            tok.decode(toks, skip_special_tokens=True), [stop])

    def generate_stream(self, params: Dict) -> Iterator[bytes]:
        """Yield accumulated-text chunks."""
        with self._lock:
            self._queue += 1
        acquired = self.semaphore.acquire(timeout=60)
        try:
            if not acquired:
                yield pack_chunk({"text": "", "error_code": ErrorCode.TIMEOUT})
                return
            prompt = params["prompt"]
            images = self._decode_images(params.get("images"))
            temperature = float(params.get("temperature", 1.0))
            max_new = int(params.get("max_new_tokens", 256))
            stop = params.get("stop") or C.DEFAULT_EOS_TOKEN
            tok = self.bundle.tokenizer

            text = self._model.build_prompt(prompt, num_images=len(images)) \
                if "USER:" not in prompt else prompt
            # placeholder expansion when the client sends raw <image> tags
            placeholder = C.image_placeholder(
                self.bundle.config.image_token_len,
                self.bundle.config.use_im_start_end)
            text = text.replace(C.DEFAULT_IMAGE_TOKEN, placeholder)
            enc = tok(text)["input_ids"]
            ids = np.asarray(
                enc[0] if enc and isinstance(enc[0], list) else enc,
                np.int32)[None]

            if self.engine is not None and not images:
                yield from self._engine_stream(ids, max_new, temperature,
                                               stop)
                return

            imgs = self._model.preprocess_images(images)
            if self.speculative and temperature <= 1e-4:
                yield pack_chunk({"text": self._speculative_text(
                    ids, imgs, max_new, stop), "error_code": 0})
                return

            gen = Generator(self.bundle.model, GenerateConfig(
                max_new_tokens=max_new, do_sample=temperature > 1e-4,
                temperature=max(temperature, 1e-4),
                eos_id=tok.eos_token_id, pad_id=tok.pad_token_id),
                device=self.device)
            collected: List[int] = []
            for step_tokens in gen.stream(ids, images=imgs, tokenizer=tok,
                                          keywords=[stop]):
                collected.append(int(step_tokens[0]))
                out_text = tok.decode(collected, skip_special_tokens=True)
                out_text = truncate_at_keywords(out_text, [stop])
                yield pack_chunk({"text": out_text, "error_code": 0})
        except Exception as e:
            # a request's failure is reported to its client; the worker
            # keeps serving
            logger.exception("generate failed")
            yield pack_chunk({"text": str(e),
                              "error_code": ErrorCode.WORKER_ERROR})
        finally:
            if acquired:
                self.semaphore.release()
            with self._lock:
                self._queue -= 1

    def stop(self):
        """Stop the engine loop and the heartbeats, and release the engine's
        device buffers."""
        self._stop.set()
        for thread in self._threads:
            thread.join(timeout=30)
        if self.engine is not None:
            self.engine.close()


def make_handler(worker: ModelWorker):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _read(self) -> Dict:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_POST(self):
            if self.path == "/worker_get_status":
                body = json.dumps(worker.status()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/worker_generate_stream":
                params = self._read()
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.end_headers()
                for chunk in worker.generate_stream(params):
                    self.wfile.write(chunk)
                    self.wfile.flush()
            else:
                self.send_response(404)
                self.end_headers()

    return Handler


def serve(bundle, *, host: str = "0.0.0.0", port: int = 21002,
          controller_address: Optional[str] = None,
          model_names: Optional[List[str]] = None,
          use_engine: bool = False, engine_slots: int = 4,
          engine_max_len: int = 2048, engine_chunk_steps: int = 8,
          engine_pipeline: int = 1,
          engine_cache_dtype=None,
          engine_spec_draft: int = 0,
          engine_prefill_chunk: int = 0,
          engine_prefill_chunk_min: int = 0,
          speculative: int = 0,
          device: Union[str, torch.device] = "cuda") -> ThreadingHTTPServer:
    """A worker and its HTTP server (not yet serving: call
    ``serve_forever``). The worker registers as ``http://host:port``, so
    pass the port it will listen on, not 0."""
    worker = ModelWorker(
        bundle, worker_address=f"http://{host}:{port}",
        controller_address=controller_address, model_names=model_names,
        use_engine=use_engine, engine_slots=engine_slots,
        engine_max_len=engine_max_len, engine_chunk_steps=engine_chunk_steps,
        engine_pipeline=engine_pipeline,
        engine_cache_dtype=engine_cache_dtype,
        engine_spec_draft=engine_spec_draft,
        engine_prefill_chunk=engine_prefill_chunk,
        engine_prefill_chunk_min=engine_prefill_chunk_min,
        speculative=speculative, device=device)
    server = ThreadingHTTPServer((host, port), make_handler(worker))
    server.worker = worker
    return server


def main(argv: Optional[List[str]] = None):
    import argparse

    from merlin_tpu_torch.models.builder import (
        build_model_tokenizer, init_or_load_params, quantize_bundle_lm_int8)
    from merlin_tpu_torch.train.arguments import parse_args

    p = argparse.ArgumentParser()
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=21002)
    p.add_argument("--controller-address", default=None)
    p.add_argument("--model-path", default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where the model runs (cpu for a test)")
    p.add_argument("--engine", action="store_true",
                   help="continuous-batching decode across slots")
    p.add_argument("--engine-slots", type=int, default=4)
    p.add_argument("--engine-chunk-steps", type=int, default=8,
                   help="decode steps per engine chunk")
    p.add_argument("--engine-pipeline", type=int, default=1,
                   help="record tokens N chunks behind the dispatch")
    p.add_argument("--engine-cache-dtype", default=None,
                   choices=[None, "bf16", "int8", "f32"],
                   help="int8 halves KV pool memory (per-token-head "
                        "scales); f32 on the CPU only")
    p.add_argument("--engine-spec-draft", type=int, default=0, metavar="K",
                   help="engine speculative decoding: every engine step "
                        "verifies K prompt-lookup draft tokens per slot")
    p.add_argument("--engine-prefill-chunk", type=int, default=0,
                   metavar="C",
                   help="admit prompts in (1, C) windows interleaved "
                        "with decode")
    p.add_argument("--engine-prefill-chunk-min", type=int, default=0,
                   metavar="T",
                   help="hybrid admission: prompts <= T tokens take the "
                        "whole-prompt prefill; longer ones chunk")
    p.add_argument("--speculative", type=int, default=0, metavar="K",
                   help="prompt-lookup speculative decoding with K-token "
                        "drafts for greedy requests (the same tokens, "
                        "fewer forwards; the answer arrives as one chunk)")
    p.add_argument("--int8-weights", action="store_true",
                   help="weight-only int8 LM kernels (per-output-channel "
                        "scales); the tower and projector stay as they are")
    p.add_argument("--scan-decode", action="store_true",
                   help="scan the LM layer stack (not ported yet: the "
                        "decoder refuses it)")
    args, rest = p.parse_known_args(argv)

    margs, dargs, targs = parse_args(rest)
    if args.model_path:
        margs.model_name_or_path = args.model_path
    if args.scan_decode:
        margs.scan_layers = True
    bundle = build_model_tokenizer(margs, dargs, targs, tiny=args.tiny)
    init_or_load_params(bundle, composite_checkpoint=margs.pretrain_model,
                        device=args.device)
    if args.int8_weights:
        bundle = quantize_bundle_lm_int8(bundle)
    server = serve(bundle, host=args.host, port=args.port,
                   controller_address=args.controller_address,
                   use_engine=args.engine, engine_slots=args.engine_slots,
                   engine_max_len=targs.model_max_length,
                   engine_chunk_steps=args.engine_chunk_steps,
                   engine_pipeline=args.engine_pipeline,
                   engine_cache_dtype=args.engine_cache_dtype,
                   engine_spec_draft=args.engine_spec_draft,
                   engine_prefill_chunk=args.engine_prefill_chunk,
                   engine_prefill_chunk_min=args.engine_prefill_chunk_min,
                   speculative=args.speculative, device=args.device)
    logger.info("worker listening on %s:%d", args.host, args.port)
    server.serve_forever()


if __name__ == "__main__":
    main()
