"""Misc multimodal utilities (a copy of ``merlin_tpu/utils/mm_utils.py``)."""

from __future__ import annotations

import io
import os
from typing import Optional


def load_image(image_file: str):
    """Open a local path or http(s) URL as an RGB PIL image."""
    from PIL import Image

    if image_file.startswith(("http://", "https://")):
        import urllib.request

        with urllib.request.urlopen(image_file, timeout=30) as resp:
            return Image.open(io.BytesIO(resp.read())).convert("RGB")
    return Image.open(image_file).convert("RGB")


def violates_moderation(text: str, api_key: Optional[str] = None) -> bool:
    """OpenAI moderation hook. Gated: returns False (allow) when no API key
    or client is available, or when the call fails (fails open, as the JAX
    package does)."""
    api_key = api_key or os.environ.get("OPENAI_API_KEY")
    if not api_key:
        return False
    try:
        import openai

        client = openai.OpenAI(api_key=api_key)
        out = client.moderations.create(input=text)
        return bool(out.results[0].flagged)
    except Exception:
        return False


def pretty_print_semaphore(sem) -> str:
    if sem is None:
        return "None"
    return f"Semaphore(value={sem._value}, locked={sem.locked()})"
