"""Minimal web chat UI (a copy of ``merlin_tpu/serve/web.py`` on the port's
``protocol``, ``constants`` and ``conversation``): the reference's
gradio_web_server.py capability — template-by-model-name,
controller-dispatched streaming, conversation + image-hash logging,
vote/flag — on the standard library alone.

Serves a single-page chat app (vanilla JS, streams the \\0-delimited chunk
protocol via fetch), a JSON relay endpoint, and a /vote endpoint.
Conversation records match the reference's JSONL schema
(gradio_web_server.py:274-286: tstamp/type/model/start/finish/state/
images/ip); uploaded images are archived once per md5 under
serve_images/YYYY-MM-DD/<hash>.jpg (:224-230).

    python -m merlin_tpu_torch.serve.web --controller http://localhost:21001
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from merlin_tpu_torch.serve.protocol import http_json
from merlin_tpu_torch.utils.constants import LOGDIR
from merlin_tpu_torch.utils.conversation import conv_templates

PAGE = """<!doctype html><html><head><meta charset='utf-8'>
<title>merlin-tpu chat</title>
<style>body{font-family:sans-serif;max-width:720px;margin:2em auto}
#log{border:1px solid #ccc;padding:1em;min-height:16em;white-space:pre-wrap}
textarea{width:100%%}</style></head><body>
<h3>merlin-tpu</h3><div id=log></div>
<p><textarea id=q rows=3 placeholder='Ask...'></textarea>
<button onclick=send()>Send</button>
<input type=file id=img accept='image/*'>
<button onclick=vote('upvote')>&#128077;</button>
<button onclick=vote('downvote')>&#128078;</button>
<button onclick=vote('flag')>&#9873;</button></p>
<script>
let history=[];
async function vote(t){
  await fetch('/vote',{method:'POST',
    body:JSON.stringify({type:t,history:history})});
}
async function send(){
  const q=document.getElementById('q').value; if(!q)return;
  history.push(['USER',q]);
  render('...');
  let images=[];
  const f=document.getElementById('img').files[0];
  if(f){images=[await new Promise(r=>{const fr=new FileReader();
    fr.onload=()=>r(fr.result.split(',')[1]);fr.readAsDataURL(f);})];}
  const resp=await fetch('/chat',{method:'POST',
    body:JSON.stringify({history:history,images:images})});
  const reader=resp.body.getReader();const dec=new TextDecoder();
  let buf='',answer='';
  while(true){const {done,value}=await reader.read();if(done)break;
    buf+=dec.decode(value,{stream:true});
    const parts=buf.split('\\u0000');buf=parts.pop();
    for(const p of parts){if(!p)continue;const c=JSON.parse(p);
      answer=c.text;render(answer);}}
  history.push(['ASSISTANT',answer]);
  document.getElementById('q').value='';render('');
}
function render(cur){
  let out='';for(const [r,m] of history)out+=r+': '+m+'\\n';
  if(cur)out+='ASSISTANT: '+cur;
  document.getElementById('log').textContent=out;}
</script></body></html>"""


def template_for_model(model_name: str) -> str:
    """Template selection by model name (gradio_web_server.py:176-200),
    mapped onto this repo's conv_templates registry."""
    name = model_name.lower()
    if "llava" in name:
        if "llama-2" in name:
            return "llama_2"
        if "v1" in name:
            if "mmtag" in name or ("plain" in name and "finetune" not in name):
                return "plain"
            return "v1"
        if "mpt" in name:
            return "mpt"
        if "mmtag" in name or ("plain" in name and "finetune" not in name):
            return "plain"
        return "v0"
    if "mpt" in name:
        return "mpt"
    if "llama-2" in name:
        return "llama_2"
    return "vicuna_v1"


def _archive_images(images_b64, log_dir: str):
    """md5-hash each uploaded image and archive it once
    (gradio_web_server.py:224-230). Returns the hash list."""
    hashes = []
    day_dir = os.path.join(log_dir, "serve_images",
                           time.strftime("%Y-%m-%d"))
    for b64 in images_b64:
        raw = base64.b64decode(b64)
        h = hashlib.md5(raw).hexdigest()
        hashes.append(h)
        path = os.path.join(day_dir, f"{h}.jpg")
        if not os.path.isfile(path):
            os.makedirs(day_dir, exist_ok=True)
            with open(path, "wb") as f:
                f.write(raw)
    return hashes


def _conv_log_path(log_dir: str) -> str:
    os.makedirs(log_dir, exist_ok=True)
    return os.path.join(log_dir, time.strftime("conv-%Y-%m-%d.jsonl"))


def make_handler(controller_address: str, model: str, log_dir: str):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_GET(self):
            body = PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _log(self, record: dict):
            with open(_conv_log_path(log_dir), "a") as f:
                f.write(json.dumps(record) + "\n")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            if self.path == "/vote":
                # vote/flag endpoint (gradio_web_server.py:92-119)
                record = {
                    "tstamp": round(time.time(), 4),
                    "type": req.get("type", "upvote"),
                    "model": req.get("model", model),
                    "state": req.get("history", []),
                    "ip": self.client_address[0],
                }
                self._log(record)
                body = b'{"ok": true}'
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return

            start_tstamp = time.time()
            model_name = req.get("model", model)
            conv = conv_templates[template_for_model(model_name)].copy()
            history = req.get("history", [])
            for role, msg in history:
                conv.append_message(conv.roles[0 if role == "USER" else 1],
                                    msg)
            conv.append_message(conv.roles[1], None)
            images = req.get("images", [])
            image_hashes = _archive_images(images, log_dir)
            payload = {"model": model_name, "prompt": conv.get_prompt(),
                       "images": images,
                       "temperature": req.get("temperature", 0.2),
                       "max_new_tokens": req.get("max_new_tokens", 512),
                       "stop": conv.sep2}
            resp = http_json("POST",
                             controller_address + "/get_worker_address",
                             {"model": model_name})
            address = resp.get("address")
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.end_headers()
            if not address:
                self.wfile.write(
                    json.dumps({"text": "no worker", "error_code": 2})
                    .encode() + b"\0")
                return
            r = urllib.request.Request(
                address + "/worker_generate_stream",
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(r, timeout=300) as stream:
                while True:
                    data = stream.read(1024)
                    if not data:
                        break
                    self.wfile.write(data)
                    self.wfile.flush()
            # conversation logging (gradio_web_server.py:274-286 schema)
            self._log({
                "tstamp": round(time.time(), 4),
                "type": "chat",
                "model": model_name,
                "start": round(start_tstamp, 4),
                "finish": round(time.time(), 4),
                "state": history,
                "images": image_hashes,
                "ip": self.client_address[0],
            })

    return Handler


def serve(controller_address: str, *, host: str = "0.0.0.0",
          port: int = 7860, model: str = "merlin-tpu",
          log_dir: str = LOGDIR) -> ThreadingHTTPServer:
    return ThreadingHTTPServer(
        (host, port), make_handler(controller_address, model, log_dir))


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--controller", default="http://localhost:21001")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--model", default="merlin-tpu")
    args = p.parse_args(argv)
    serve(args.controller, host=args.host, port=args.port,
          model=args.model).serve_forever()


if __name__ == "__main__":
    main()
