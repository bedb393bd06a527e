"""Serving smoke tools (a copy of ``merlin_tpu/serve/tools.py`` on the
port's ``cli``, ``protocol`` and ``conversation``): the reference's
engine/serve/register_worker.py and test_message.py, both broken as
shipped there.

    python -m merlin_tpu_torch.serve.tools --controller \
        http://localhost:21001 --message "hello"
"""

from __future__ import annotations

from merlin_tpu_torch.serve.cli import stream_request
from merlin_tpu_torch.serve.protocol import http_json
from merlin_tpu_torch.utils.conversation import conv_templates


def register_worker(controller_address: str, worker_name: str,
                    check_heart_beat: bool = True) -> dict:
    """Manual worker registration (register_worker.py)."""
    return http_json("POST", controller_address + "/register_worker", {
        "worker_name": worker_name, "check_heart_beat": check_heart_beat,
        "worker_status": None})


def test_message(controller_address: str, *, model: str = "merlin-tpu",
                 message: str = "Tell me a story with more than 1000 words.",
                 max_new_tokens: int = 32, print_fn=print) -> str:
    """Send one message through controller dispatch (test_message.py)."""
    models = http_json("POST", controller_address + "/list_models").get(
        "models", [])
    print_fn(f"models: {models}")
    resp = http_json("POST", controller_address + "/get_worker_address",
                     {"model": model})
    address = resp.get("address")
    print_fn(f"worker: {address}")
    if not address:
        return ""
    conv = conv_templates["v1"].copy()
    conv.append_message(conv.roles[0], message)
    conv.append_message(conv.roles[1], None)
    answer = ""
    for chunk in stream_request(address, {
            "model": model, "prompt": conv.get_prompt(),
            "temperature": 0.0, "max_new_tokens": max_new_tokens,
            "stop": conv.sep2}):
        if chunk.get("error_code"):
            print_fn(f"error: {chunk}")
            break
        answer = chunk["text"]
    print_fn(answer)
    return answer


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--controller", default="http://localhost:21001")
    p.add_argument("--register-worker", default=None)
    p.add_argument("--message", default=None)
    args = p.parse_args(argv)
    if args.register_worker:
        print(register_worker(args.controller, args.register_worker))
    if args.message:
        test_message(args.controller, message=args.message)


if __name__ == "__main__":
    main()
