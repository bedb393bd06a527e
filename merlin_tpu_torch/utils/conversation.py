"""Conversation prompt templates (a copy of
``merlin_tpu/utils/conversation.py``): a dataclass holding chat history
plus a family of separator styles that render it to one prompt string,
the ``conv_templates`` registry and ``default_conversation``.

Rendering rules (must match the reference exactly — training masks are
computed by splitting on these separators):

* ``TWO`` (vicuna v1): ``system + sep`` then alternating
  ``"ROLE: message" + sep_i`` where ``sep_i`` alternates between ``sep``
  (" ") and ``sep2`` ("</s>").  An empty/None message renders ``"ROLE:"``
  with no trailing separator (generation prefix).
* ``SINGLE``: ``system + sep`` then ``"ROLE: message" + sep`` per turn.
* ``MPT``: ``system + sep`` then ``role + message + sep`` (roles carry
  their own ``<|im_start|>``-style markers).
* ``PLAIN``: no roles; messages joined by alternating ``sep``/``sep2``.
* ``LLAMA_2``: ``[INST] ... [/INST]`` wrapping with ``<<SYS>>`` block in
  the first user turn.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple


class SeparatorStyle(enum.Enum):
    SINGLE = enum.auto()
    TWO = enum.auto()
    MPT = enum.auto()
    PLAIN = enum.auto()
    LLAMA_2 = enum.auto()


def _msg_text(message) -> str:
    """Messages may be (text, image, preprocess_mode) tuples in the UI path."""
    if isinstance(message, tuple):
        return message[0]
    return message


@dataclasses.dataclass
class Conversation:
    """Chat history plus the rules for rendering it into one prompt."""

    system: str
    roles: Tuple[str, str]
    messages: List[List]
    offset: int = 0
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: Optional[str] = None
    version: str = "unknown"

    def get_prompt(self) -> str:
        messages = self.messages
        # UI path: the first user message may be (text, image, mode); hoist the
        # <image> token to the front of the text — or, for 'mmtag' template
        # versions, wrap it as a separate <Image>..</Image> exchange
        # (reference conversation.py:35-39).
        if messages and isinstance(messages[0][1], tuple):
            messages = [list(m) for m in messages]
            first_role, first_msg = messages[0]
            text = first_msg[0].replace("<image>", "").strip()
            if "mmtag" in self.version:
                messages[0] = [first_role, text]
                messages.insert(0, [self.roles[0], "<Image><image></Image>"])
                messages.insert(1, [self.roles[1], "Received."])
            else:
                messages[0] = [first_role, "<image>\n" + text]

        if self.sep_style == SeparatorStyle.SINGLE:
            out = self.system + self.sep
            for role, message in messages:
                if message:
                    out += role + ": " + _msg_text(message) + self.sep
                else:
                    out += role + ":"
            return out

        if self.sep_style == SeparatorStyle.TWO:
            seps = (self.sep, self.sep2)
            out = self.system + seps[0]
            for i, (role, message) in enumerate(messages):
                if message:
                    out += role + ": " + _msg_text(message) + seps[i % 2]
                else:
                    out += role + ":"
            return out

        if self.sep_style == SeparatorStyle.MPT:
            out = self.system + self.sep
            for role, message in messages:
                if message:
                    out += role + _msg_text(message) + self.sep
                else:
                    out += role
            return out

        if self.sep_style == SeparatorStyle.PLAIN:
            seps = (self.sep, self.sep2)
            out = self.system
            for i, (_, message) in enumerate(messages):
                if message:
                    out += _msg_text(message) + seps[i % 2]
            return out

        if self.sep_style == SeparatorStyle.LLAMA_2:
            out = ""
            for i, (role, message) in enumerate(messages):
                if i == 0 and not message:
                    raise ValueError("first message must be non-empty")
                if not message:
                    continue
                text = _msg_text(message)
                if i == 0:
                    text = f"<<SYS>>\n{self.system}\n<</SYS>>\n\n" + text
                if i % 2 == 0:
                    out += self.sep + f"[INST] {text} [/INST]"
                else:
                    out += " " + text + " " + self.sep2
            return out.lstrip(self.sep)

        raise ValueError(f"invalid separator style: {self.sep_style}")

    def append_message(self, role: str, message) -> None:
        self.messages.append([role, message])

    @staticmethod
    def _resize_for_ui(image, mode: str):
        """Reference display sizing (conversation.py:118-143): optional
        Pad/Resize preprocessing, then bound the short edge to <=400 and
        the long edge to <=800 preserving aspect."""
        from PIL import Image

        if mode == "Pad":
            w, h = image.size
            if w != h:
                side = max(w, h)
                bg = Image.new(image.mode, (side, side), (122, 116, 104))
                bg.paste(image, ((side - w) // 2 if h > w else 0,
                                 (side - h) // 2 if w > h else 0))
                image = bg
        elif mode == "Resize":
            image = image.resize((336, 336))
        elif mode not in ("Crop", "Default"):
            raise ValueError(f"Invalid image_process_mode: {mode}")
        max_hw, min_hw = max(image.size), min(image.size)
        aspect = max_hw / min_hw
        shortest = int(min(800 / aspect, 400, min_hw))
        longest = int(shortest * aspect)
        w, h = image.size
        size = (shortest, longest) if h > w else (longest, shortest)
        return image.resize(size)

    def get_images(self, return_pil: bool = False) -> list:
        """Extract user-turn images ((text, PIL, mode) message tuples) at
        display size; base64 PNG strings unless ``return_pil``
        (reference conversation.py:109-155)."""
        images = []
        for i, (_, msg) in enumerate(self.messages[self.offset:]):
            if i % 2 == 0 and isinstance(msg, tuple):
                _, image, mode = msg
                image = self._resize_for_ui(image, mode)
                if return_pil:
                    images.append(image)
                else:
                    import base64
                    from io import BytesIO

                    buf = BytesIO()
                    image.save(buf, format="PNG")
                    images.append(base64.b64encode(buf.getvalue()).decode())
        return images

    def to_chatbot(self) -> list:
        """[[user_html, assistant_text], ...] pairs for a chat UI; image
        turns render as an inline base64 <img> followed by their text
        (reference to_gradio_chatbot, conversation.py:157-189 — the UI
        tier here is the dependency-free serve/web.py)."""
        out = []
        for i, (_, msg) in enumerate(self.messages[self.offset:]):
            if i % 2 == 0:
                if isinstance(msg, tuple):
                    import base64
                    from io import BytesIO

                    text, image, mode = msg
                    image = self._resize_for_ui(image, mode)
                    buf = BytesIO()
                    image.save(buf, format="PNG")
                    b64 = base64.b64encode(buf.getvalue()).decode()
                    out.append([f'<img src="data:image/png;base64,{b64}" '
                                f'alt="user upload image" />', None])
                    text = text.replace("<image>", "").strip()
                    if text:
                        out.append([text, None])
                else:
                    out.append([msg, None])
            elif out:
                out[-1][-1] = msg
        return out

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system,
            roles=self.roles,
            messages=[[r, m] for r, m in self.messages],
            offset=self.offset,
            sep_style=self.sep_style,
            sep=self.sep,
            sep2=self.sep2,
            version=self.version,
        )

    def dict(self) -> dict:
        return {
            "system": self.system,
            "roles": list(self.roles),
            "messages": [[r, _msg_text(m)] for r, m in self.messages],
            "offset": self.offset,
            "sep": self.sep,
            "sep2": self.sep2,
        }


# ---------------------------------------------------------------------------
# Templates
# ---------------------------------------------------------------------------

conv_vicuna_v1 = Conversation(
    system=(
        "A chat between a curious user and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the user's questions."
    ),
    roles=("USER", "ASSISTANT"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1",
)

conv_vicuna_v0 = Conversation(
    system=(
        "A chat between a curious human and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the human's questions."
    ),
    roles=("Human", "Assistant"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
    version="v0",
)

conv_llama_2 = Conversation(
    system=(
        "You are a helpful language and vision assistant. "
        "You are able to understand the visual content that the user provides, "
        "and assist the user with a variety of tasks using natural language."
    ),
    roles=("USER", "ASSISTANT"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
    version="llama_v2",
)

conv_mpt = Conversation(
    system="<|im_start|>system\nA conversation between a user and an LLM-based AI assistant. "
    "The assistant gives helpful and honest answers.",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
    version="mpt",
)

conv_plain = Conversation(
    system="",
    roles=("", ""),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
    sep2="</s>",
    version="plain",
)

# 'mmtag' version: first image turn renders as a separate
# <Image><image></Image> exchange (reference conversation.py:35-39).
conv_vicuna_v1_mmtag = dataclasses.replace(
    conv_vicuna_v1, messages=[], version="v1_mmtag")

# Reference exposes one global ``conv`` = vicuna v1 (conversation.py:222).
conv = conv_vicuna_v1

conv_templates = {
    "v0": conv_vicuna_v0,
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "v1_mmtag": conv_vicuna_v1_mmtag,
    "llama_2": conv_llama_2,
    "mpt": conv_mpt,
    "plain": conv_plain,
    "default": conv_vicuna_v1,
}

default_conversation = conv_vicuna_v1
