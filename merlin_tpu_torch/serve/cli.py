"""Terminal chat client (counterpart of ``merlin_tpu/serve/cli.py``).

Talks to the controller (or to a worker directly), keeps the multi-turn
history in a ``Conversation``, and prints tokens as they stream in (the
JAX client reads 1024-byte blocks, so its tokens arrive in bursts).

    python -m merlin_tpu_torch.serve.cli --address http://localhost:21001 \
        --controller --model merlin-tpu
"""

from __future__ import annotations

import base64
import json
import urllib.request
from typing import List, Optional

from merlin_tpu_torch.serve.protocol import DELIMITER, http_json
from merlin_tpu_torch.utils import constants as C
from merlin_tpu_torch.utils.conversation import conv_templates


def stream_request(address: str, payload: dict):
    req = urllib.request.Request(
        address + "/worker_generate_stream",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        buf = b""
        while True:
            # read1: each chunk as it arrives (read(n) waits for n bytes)
            data = resp.read1(1024)
            if not data:
                break
            buf += data
            while DELIMITER in buf:
                chunk, buf = buf.split(DELIMITER, 1)
                if chunk:
                    yield json.loads(chunk)


def chat(address: str, *, model: str = "merlin-tpu",
         conv_template: str = "v1", image_path: Optional[str] = None,
         temperature: float = 0.2, max_new_tokens: int = 512,
         input_fn=input, print_fn=print, via_controller: bool = False):
    conv = conv_templates[conv_template].copy()
    images_b64: List[str] = []
    if image_path:
        with open(image_path, "rb") as f:
            images_b64.append(base64.b64encode(f.read()).decode())

    first = True
    while True:
        try:
            text = input_fn(f"{conv.roles[0]}: ").strip()
        except (EOFError, KeyboardInterrupt):
            return
        if not text or text in ("quit", "exit"):
            return
        if first and images_b64 and C.DEFAULT_IMAGE_TOKEN not in text:
            text = C.DEFAULT_IMAGE_TOKEN + "\n" + text
        first = False
        conv.append_message(conv.roles[0], text)
        conv.append_message(conv.roles[1], None)
        payload = {
            "model": model,
            "prompt": conv.get_prompt(),
            "images": images_b64,
            "temperature": temperature,
            "max_new_tokens": max_new_tokens,
            "stop": conv.sep2,
        }
        endpoint = address
        if via_controller:
            resp = http_json("POST", address + "/get_worker_address",
                             {"model": model})
            endpoint = resp.get("address") or address
        print_fn(f"{conv.roles[1]}: ", end="", flush=True)
        answer = ""
        for chunk in stream_request(endpoint, payload):
            if chunk.get("error_code"):
                print_fn(f"[error {chunk['error_code']}] {chunk.get('text','')}")
                break
            new = chunk["text"]
            print_fn(new[len(answer):], end="", flush=True)
            answer = new
        print_fn("")
        conv.messages[-1][1] = answer


def main():
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--address", default="http://localhost:21002")
    p.add_argument("--controller", action="store_true")
    p.add_argument("--model", default="merlin-tpu")
    p.add_argument("--image", default=None)
    p.add_argument("--temperature", type=float, default=0.2)
    p.add_argument("--max-new-tokens", type=int, default=512)
    args = p.parse_args()
    chat(args.address, model=args.model, image_path=args.image,
         temperature=args.temperature, max_new_tokens=args.max_new_tokens,
         via_controller=args.controller)


if __name__ == "__main__":
    main()
