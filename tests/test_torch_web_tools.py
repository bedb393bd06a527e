"""The port's web chat server and serve tools (``merlin_tpu_torch.serve.
web`` and ``.tools``) against the JAX package's, on the CPU (mirrors
``tests/test_serve.py:101,196,211``).

One controller and one worker of the port on loopback (the tiny bundle,
greedy); JAX's web server and the port's relay the same requests to it:
the streamed bytes, the conversation JSONL records (``tstamp``/``start``/
``finish`` aside) and the archived image must be the same.
``test_message`` and ``register_worker`` of both packages against that
controller give the same answers. Also ``template_for_model``'s rules and
the ``python -m`` entry points' argument parsing.
"""

import base64
import glob
import io
import json
import socket
import threading
import urllib.request

import pytest
import torch
from PIL import Image

from merlin_tpu.serve import tools as j_tools
from merlin_tpu.serve import web as j_web

from merlin_tpu_torch.models import builder as t_builder
from merlin_tpu_torch.serve import controller as t_controller
from merlin_tpu_torch.serve import tools as t_tools
from merlin_tpu_torch.serve import web as t_web
from merlin_tpu_torch.serve import worker as t_worker
from merlin_tpu_torch.serve.protocol import http_json
from merlin_tpu_torch.train.arguments import parse_args

CLOCKS = ("tstamp", "start", "finish")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(server, servers):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    servers.append(server)


@pytest.fixture(scope="module")
def stack():
    bundle = t_builder.build_model_tokenizer(*parse_args(
        ["--image_size", "16", "--model_max_length", "128"]), tiny=True)
    t_builder.init_or_load_params(bundle, device="cpu")
    bundle.model.eval()
    # every word the requests hold gets an id the vocabulary has (C20)
    bundle.tokenizer.encode("hello there Tell me a story with more than "
                            "1000 words. hi", add_special_tokens=False)
    servers = []
    ctrl_server = t_controller.serve(host="127.0.0.1", port=0)
    _serve(ctrl_server, servers)
    ctrl = f"http://127.0.0.1:{ctrl_server.server_address[1]}"
    wk = t_worker.serve(bundle, host="127.0.0.1", port=_free_port(),
                        controller_address=ctrl, device="cpu")
    _serve(wk, servers)
    yield dict(ctrl=ctrl, worker=wk.worker)
    wk.worker.stop()
    for server in servers:
        server.shutdown()
        server.server_close()
    ctrl_server.controller.stop()


def test_template_for_model():
    cases = {"llava-llama-2-13b": "llama_2", "llava-v1.5-7b": "v1",
             "llava-v1-mmtag": "plain", "llava-pretrain-plain": "plain",
             "llava-mpt-7b": "mpt", "llava-13b": "v0",
             "mpt-30b-chat": "mpt", "Llama-2-13b-chat": "llama_2",
             "vicuna-13b": "vicuna_v1", "llava-v1-plain-finetune": "v1"}
    for name, want in cases.items():
        assert t_web.template_for_model(name) == want, name
        assert j_web.template_for_model(name) == want, name


def _post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read()


def _web_session(web_mod, ctrl, log_dir, img_b64):
    """A flag vote, then a chat with one image, through ``web_mod``'s
    server: (the chat's raw bytes, the JSONL records, archived files)."""
    srv = web_mod.ThreadingHTTPServer(
        ("127.0.0.1", 0), web_mod.make_handler(ctrl, "merlin-tpu", log_dir))
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        assert json.loads(_post(port, "/vote", {
            "type": "flag", "history": [["USER", "hi"]]}))["ok"] is True
        raw = _post(port, "/chat", {
            "history": [["USER", "hello there"]], "images": [img_b64],
            "max_new_tokens": 4, "temperature": 0.0})
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                    timeout=10) as r:
            page = r.read()
    finally:
        srv.shutdown()
        srv.server_close()
    logs = glob.glob(log_dir + "/conv-*.jsonl")
    assert len(logs) == 1
    records = [json.loads(line) for line in open(logs[0])]
    archived = sorted(p[len(log_dir):] for p in glob.glob(
        log_dir + "/serve_images/*/*.jpg"))
    return raw, records, archived, page


def test_web_vote_and_chat_logging_match_jax(stack, tmp_path):
    buf = io.BytesIO()
    Image.new("RGB", (8, 8), (9, 9, 9)).save(buf, "PNG")
    img_b64 = base64.b64encode(buf.getvalue()).decode()
    got = _web_session(t_web, stack["ctrl"], str(tmp_path / "port"),
                       img_b64)
    want = _web_session(j_web, stack["ctrl"], str(tmp_path / "jax"),
                        img_b64)
    raw, records, archived, page = got
    assert b"\0" in raw
    chunks = [json.loads(c) for c in raw.split(b"\0") if c]
    assert chunks and all(c["error_code"] == 0 for c in chunks)
    assert raw == want[0]
    assert page == want[3] and b"<textarea" in page
    strip = [{k: v for k, v in r.items() if k not in CLOCKS}
             for r in records]
    assert strip == [{k: v for k, v in r.items() if k not in CLOCKS}
                     for r in want[1]]
    assert [r["type"] for r in records] == ["flag", "chat"]
    chat = records[1]
    assert chat["model"] == "merlin-tpu" and len(chat["images"]) == 1
    assert chat["start"] <= chat["finish"]
    assert archived == want[2] and len(archived) == 1
    assert chat["images"][0] in archived[0]


def test_web_without_worker_answers_no_worker(tmp_path):
    ctrl_server = t_controller.serve(host="127.0.0.1", port=0)
    servers = []
    _serve(ctrl_server, servers)
    ctrl = f"http://127.0.0.1:{ctrl_server.server_address[1]}"
    srv = t_web.serve(ctrl, host="127.0.0.1", port=0,
                      log_dir=str(tmp_path))
    _serve(srv, servers)
    try:
        raw = _post(srv.server_address[1], "/chat",
                    {"history": [["USER", "hi"]]})
        assert json.loads(raw.split(b"\0")[0]) == {"text": "no worker",
                                                   "error_code": 2}
    finally:
        for server in servers:
            server.shutdown()
            server.server_close()
        ctrl_server.controller.stop()


def test_message_tool_matches_jax(stack):
    printed = []
    got = t_tools.test_message(stack["ctrl"], message="hello there",
                               max_new_tokens=3, print_fn=printed.append)
    want = j_tools.test_message(stack["ctrl"], message="hello there",
                                max_new_tokens=3,
                                print_fn=lambda *a, **k: None)
    assert isinstance(got, str) and got == want
    assert printed[0] == "models: ['merlin-tpu']"
    assert printed[1] == f"worker: {stack['worker'].worker_address}"


def test_register_worker_matches_jax(stack):
    addr = stack["worker"].worker_address
    assert t_tools.register_worker(stack["ctrl"], addr) == \
        j_tools.register_worker(stack["ctrl"], addr) == {"exist": True}
    assert http_json("POST", stack["ctrl"] + "/list_models")["models"] == \
        ["merlin-tpu"]
    assert t_tools.register_worker(stack["ctrl"], "http://127.0.0.1:9") == \
        {"exist": False}


def test_entry_points_parse_their_flags(monkeypatch):
    seen = {}

    class Fake:
        def serve_forever(self):
            seen["served"] = True

    monkeypatch.setattr(t_web, "serve", lambda ctrl, **kw: (
        seen.update(ctrl=ctrl, **kw), Fake())[1])
    t_web.main(["--controller", "http://c:1", "--port", "7000",
                "--model", "m"])
    assert seen == dict(ctrl="http://c:1", host="0.0.0.0", port=7000,
                        model="m", served=True)
    calls = []
    monkeypatch.setattr(t_tools, "register_worker",
                        lambda c, w: calls.append(("register", c, w)))
    monkeypatch.setattr(t_tools, "test_message",
                        lambda c, message: calls.append(("message", c,
                                                         message)))
    t_tools.main(["--controller", "http://c:1", "--register-worker", "w",
                  "--message", "hi"])
    assert calls == [("register", "http://c:1", "w"),
                     ("message", "http://c:1", "hi")]
