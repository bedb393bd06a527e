"""The port's serving front end (controller -> model worker -> CLI over
HTTP on loopback) against the JAX package's, on the CPU.

  * The controller: registration, listing, shortest-queue and lottery
    dispatch (lottery drawn from a seeded ``np.random``, as JAX draws it),
    heartbeats, expiry, and the WORKER_ABSENT relay.
  * The port's worker and the JAX worker, each behind a controller, hold
    the same tiny MMGPT parameters and tokenizers primed alike, and give
    the same text for text and base64-PNG image requests: plain
    (``Generator.stream``), engine-backed (text through the
    ``ServingEngine``, images through the stream) and speculative.
  * ``cli.chat`` with a scripted ``input_fn`` prints JAX's transcript.
  * ``python -m merlin_tpu_torch.serve.worker --tiny --device cpu``
    answers a request.
  * ``engine_cache_dtype="f32"`` is refused on a CUDA device (read from
    the code: the CPU test has no card).
"""

import ast
import base64
import inspect
import io
import json
import os
import pathlib
import socket
import subprocess
import sys
import textwrap
import threading
import time

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from merlin_tpu.models import builder as j_builder
from merlin_tpu.serve import cli as j_cli
from merlin_tpu.serve import controller as j_controller
from merlin_tpu.serve import worker as j_worker
from merlin_tpu.train import arguments as j_arguments

from merlin_tpu_torch.models import builder as t_builder
from merlin_tpu_torch.models.bridge import params_from_flax
from merlin_tpu_torch.serve import cli as t_cli
from merlin_tpu_torch.serve import controller as t_controller
from merlin_tpu_torch.serve import worker as t_worker
from merlin_tpu_torch.serve.protocol import ErrorCode, http_json
from merlin_tpu_torch.train import arguments as t_arguments
from merlin_tpu_torch.utils.conversation import conv_templates

ROOT = pathlib.Path(__file__).resolve().parent.parent
VOCAB_TINY = 128
QUESTIONS = ["what is shown here", "count the dogs please",
             "where is the cat now"]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _args(module):
    return (module.ModelArguments(), module.DataArguments(image_size=16),
            module.TrainingArguments(gradient_checkpointing=False,
                                     model_max_length=128))


def _prime(jtok, ttok):
    """One string of distinct words through both tokenizers: the template's
    and the questions' words first, then fillers up to the vocabulary, so
    every id the model can emit decodes to its own word."""
    conv = conv_templates["v1"].copy()
    conv.append_message(conv.roles[0], " ".join(QUESTIONS))
    conv.append_message(conv.roles[1], None)
    words = list(dict.fromkeys(jtok.tokenize(conv.get_prompt())))
    words = [w for w in words
             if jtok.convert_tokens_to_ids(w) == jtok.unk_token_id]
    words += [f"w{i}" for i in range(VOCAB_TINY - len(jtok._vocab)
                                     - len(words))]
    line = " ".join(words)
    assert jtok.encode(line) == ttok.encode(line)
    assert len(jtok._vocab) == len(ttok._vocab) == VOCAB_TINY


@pytest.fixture(scope="module")
def bundles():
    jb = j_builder.build_model_tokenizer(*_args(j_arguments), tiny=True)
    j_builder.init_or_load_params(jb, rng=jax.random.key(3))
    tb = t_builder.build_model_tokenizer(*_args(t_arguments), tiny=True)
    tb.model.load_state_dict(params_from_flax(jax.device_get(jb.params)),
                             strict=True, assign=True)
    tb.params = tb.model.state_dict()
    _prime(jb.tokenizer, tb.tokenizer)
    return jb, tb


def _png_b64(seed) -> str:
    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 256, size=(30, 40, 3),
                                       dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


class _Stack:
    """A controller and one worker per package on loopback."""

    def __init__(self, bundles, **worker_kw):
        jb, tb = bundles
        self.servers = []
        self.workers = []
        self.ctrl = {}
        for name, ctrl_mod, serve_worker in (
                ("jax", j_controller, self._jax_worker),
                ("port", t_controller, self._port_worker)):
            server = ctrl_mod.serve(host="127.0.0.1", port=0)
            self._run(server)
            addr = f"http://127.0.0.1:{server.server_address[1]}"
            self.ctrl[name] = addr
            serve_worker(jb if name == "jax" else tb, addr, worker_kw)

    def _run(self, server):
        threading.Thread(target=server.serve_forever, daemon=True).start()
        self.servers.append(server)

    def _jax_worker(self, bundle, ctrl, kw):
        kw = dict(kw)
        if kw.get("use_engine"):
            kw["engine_cache_dtype"] = "f32"
        worker = j_worker.ModelWorker(bundle, worker_address="PLACEHOLDER",
                                      model_names=["merlin"], **kw)
        server = j_worker.ThreadingHTTPServer(
            ("127.0.0.1", 0), j_worker.make_handler(worker))
        worker.worker_address = f"http://127.0.0.1:{server.server_address[1]}"
        worker.controller_address = ctrl
        self._run(server)
        worker.register()
        self.workers.append(worker)

    def _port_worker(self, bundle, ctrl, kw):
        kw = dict(kw)
        if kw.get("use_engine"):
            kw["engine_cache_dtype"] = "f32"
        server = t_worker.serve(bundle, host="127.0.0.1", port=_free_port(),
                                controller_address=ctrl,
                                model_names=["merlin"], device="cpu", **kw)
        self._run(server)
        self.workers.append(server.worker)

    def ask(self, which, **payload):
        payload = dict(dict(model="merlin", temperature=0.0,
                            max_new_tokens=8, stop="</s>"), **payload)
        cli = t_cli if which == "port" else j_cli
        return list(cli.stream_request(self.ctrl[which], payload))

    def close(self):
        for worker in self.workers:
            worker.stop()
        for server in self.servers:
            server.shutdown()
            server.server_close()
            if hasattr(server, "controller"):
                server.controller.stop()


def _texts(chunks):
    assert chunks and all(c["error_code"] == 0 for c in chunks), chunks
    texts = [c["text"] for c in chunks]
    for a, b in zip(texts, texts[1:]):
        assert b.startswith(a), (a, b)
    return texts


@pytest.mark.parametrize("worker_kw", [dict(), dict(use_engine=True,
                                                     engine_slots=2,
                                                     engine_max_len=256),
                                       dict(speculative=3)],
                         ids=["plain", "engine", "speculative"])
def test_port_worker_gives_jax_text(bundles, worker_kw):
    stack = _Stack(bundles, **worker_kw)
    try:
        requests = [dict(prompt=QUESTIONS[0]),
                    dict(prompt="<image>\n" + QUESTIONS[1],
                         images=[_png_b64(1)]),
                    dict(prompt=QUESTIONS[2] + " <image> <image>",
                         images=[_png_b64(2), _png_b64(3)])]
        for req in requests:
            got = _texts(stack.ask("port", **req))
            want = _texts(stack.ask("jax", **req))
            assert got[-1] == want[-1] and got[-1], (req["prompt"], got,
                                                     want)
            if worker_kw.get("speculative"):
                assert len(got) == 1
            elif not (worker_kw.get("use_engine") and "images" not in req):
                assert got == want
    finally:
        stack.close()


def _controllers():
    return j_controller.Controller("lottery"), t_controller.Controller(
        "lottery")


def _status(names, speed=1.0, queue=0):
    return {"model_names": names, "speed": speed, "queue_length": queue}


def test_controller_dispatch_matches_jax():
    jc, tc = _controllers()
    try:
        for c in (jc, tc):
            c.register_worker("http://a", True, _status(["m", "x"], 1.0))
            c.register_worker("http://b", True, _status(["m"], 3.0))
            c.register_worker("http://c", False, _status(["y"], 0.5, 7))
        assert tc.list_models() == jc.list_models() == ["m", "x", "y"]
        picks = []
        for c in (jc, tc):
            np.random.seed(1234)
            picks.append([c.get_worker_address("m") for _ in range(40)])
        assert picks[0] == picks[1]
        assert set(picks[1]) == {"http://a", "http://b"}
        assert tc.get_worker_address("missing") == ""

        for c in (jc, tc):
            c.dispatch_method = type(c.dispatch_method).SHORTEST_QUEUE
            c.receive_heart_beat("http://a", 2)
            c.receive_heart_beat("http://b", 3)
        # queue over speed: a 2 / 1, b 3 / 3; each pick adds one to its
        # queue, and a tie goes to the first registered
        seq = [[c.get_worker_address("m") for _ in range(4)]
               for c in (jc, tc)]
        assert seq[0] == seq[1] == ["http://b", "http://b", "http://b",
                                    "http://a"]
        assert tc.workers["http://a"].queue_length == 3

        assert tc.receive_heart_beat("http://a", 0) is True
        assert tc.receive_heart_beat("http://nowhere", 0) is False
        for c in (jc, tc):
            c.workers["http://a"].last_heart_beat = time.time() - 999
            c.workers["http://c"].last_heart_beat = time.time() - 999
            c.remove_stale_workers()
        # c does not check its heartbeat: it stays
        assert sorted(tc.workers) == sorted(jc.workers) == [
            "http://b", "http://c"]
        assert not tc.register_worker("http://127.0.0.1:1", True, None)
    finally:
        jc.stop()
        tc.stop()


def test_controller_relays_absent_model_and_lists_over_http():
    server = t_controller.serve(host="127.0.0.1", port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    addr = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        http_json("POST", addr + "/register_worker", {
            "worker_name": "http://127.0.0.1:1", "check_heart_beat": True,
            "worker_status": _status(["ghost"])})
        assert http_json("POST", addr + "/list_models")["models"] == [
            "ghost"]
        chunks = list(t_cli.stream_request(addr, {"model": "missing",
                                                  "prompt": "x"}))
        assert chunks == [{"text": "", "error_code": int(
            ErrorCode.WORKER_ABSENT)}]
        # a registered worker that does not answer: WORKER_ERROR
        chunks = list(t_cli.stream_request(addr, {"model": "ghost",
                                                  "prompt": "x"}))
        assert chunks[-1]["error_code"] == int(ErrorCode.WORKER_ERROR)
        assert http_json("POST", addr + "/receive_heart_beat", {
            "worker_name": "http://127.0.0.1:1"})["exist"]
    finally:
        server.shutdown()
        server.server_close()
        server.controller.stop()


def test_relay_and_client_pass_each_chunk_on_as_it_arrives():
    """A worker that sends its second chunk only once the client holds the
    first: the relay and the client must not wait for more bytes (the JAX
    relay reads 4096-byte blocks and its client 1024-byte ones, so there
    the first chunk waits for the rest)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from merlin_tpu_torch.serve.protocol import pack_chunk

    got_first = threading.Event()

    class Worker(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            if self.path == "/worker_get_status":
                body = json.dumps(_status(["slow"])).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            self.send_response(200)
            self.end_headers()
            self.wfile.write(pack_chunk({"text": "a", "error_code": 0}))
            self.wfile.flush()
            got_first.wait(timeout=20)
            self.wfile.write(pack_chunk({"text": "a b", "error_code": 0}))

    worker = ThreadingHTTPServer(("127.0.0.1", 0), Worker)
    ctrl = t_controller.serve(host="127.0.0.1", port=0)
    for server in (worker, ctrl):
        threading.Thread(target=server.serve_forever, daemon=True).start()
    addr = f"http://127.0.0.1:{ctrl.server_address[1]}"
    try:
        ctrl.controller.register_worker(
            f"http://127.0.0.1:{worker.server_address[1]}", True, None)
        t0 = time.perf_counter()
        texts = []
        for chunk in t_cli.stream_request(addr, {"model": "slow"}):
            texts.append(chunk["text"])
            if len(texts) == 1:
                first_s = time.perf_counter() - t0
                got_first.set()
        assert texts == ["a", "a b"]
        assert first_s < 10, first_s
    finally:
        got_first.set()
        for server in (worker, ctrl):
            server.shutdown()
            server.server_close()
        ctrl.controller.stop()


def test_cli_chat_prints_jax_transcript(bundles):
    stack = _Stack(bundles)
    try:
        transcripts = []
        for which, cli in (("jax", j_cli), ("port", t_cli)):
            lines = iter([QUESTIONS[0], QUESTIONS[2], "quit"])
            printed = []
            cli.chat(stack.ctrl[which], model="merlin", temperature=0.0,
                     max_new_tokens=6, input_fn=lambda _: next(lines),
                     print_fn=lambda *a, **k: printed.append(
                         "".join(map(str, a))),
                     via_controller=True)
            transcripts.append("".join(printed))
        assert transcripts[0] == transcripts[1]
        assert transcripts[1].count("ASSISTANT:") == 2
        assert len(transcripts[1]) > 2 * len("ASSISTANT: ")
    finally:
        stack.close()


def test_worker_main_answers_on_the_cpu():
    port = _free_port()
    env = dict(os.environ, HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1",
               PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "merlin_tpu_torch.serve.worker", "--tiny",
         "--device", "cpu", "--host", "127.0.0.1", "--port", str(port),
         "--image_size", "16"],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    try:
        addr = f"http://127.0.0.1:{port}"
        deadline = time.time() + 120
        while True:
            try:
                status = http_json("POST", addr + "/worker_get_status")
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read().decode()
                assert time.time() < deadline, "the worker did not start"
                time.sleep(0.5)
        assert status["model_names"] == ["merlin-tpu"]
        chunks = list(t_cli.stream_request(addr, {
            "prompt": "hello there", "temperature": 0.0,
            "max_new_tokens": 3}))
        assert chunks and all(c["error_code"] == 0 for c in chunks)
        assert len(chunks) <= 3
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stderr.close()


def test_f32_pages_are_refused_on_the_card():
    """On a CUDA device the worker refuses ``engine_cache_dtype='f32'``
    before building the engine: the paged kernels take bf16 or int8."""
    fn = ast.parse(textwrap.dedent(inspect.getsource(
        t_worker.ModelWorker.__init__)))
    guards = [n for n in ast.walk(fn) if isinstance(n, ast.If)
              and ast.unparse(n.test) == "self.device.type == 'cuda' and "
              "kw['cache_dtype'] == torch.float32"]
    assert len(guards) == 1
    raise_ = guards[0].body[0]
    assert isinstance(raise_, ast.Raise) and "bf16 or int8" in \
        ast.unparse(raise_)
    engine = [n for n in ast.walk(fn) if isinstance(n, ast.Assign)
              and ast.unparse(n.targets[0]) == "self.engine"
              and "ServingEngine" in ast.unparse(n.value)]
    assert engine and guards[0].lineno < engine[0].lineno
    assert t_worker.CACHE_DTYPES["f32"] == torch.float32
