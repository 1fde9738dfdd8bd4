"""Prompt templating: LLaVA-style conversation state machine (the port's
copy of ``videotgb_tpu/data/conversation.py``, which holds no JAX; the
port keeps its own copy and imports nothing of the JAX package).

Behavioral port of the reference's Conversation dataclass and template table
(reference: src/data/components/conversation.py:16-310): five separator
styles (SINGLE, TWO, MPT, PLAIN, LLAMA_2) and the template registry used by
the IV/IVT datasets (vicuna_v1 is the default — ivinstruct_dataset.py:80)
and the demo's lstp template (demo/utils/prompt.py:397).
"""

from __future__ import annotations

import dataclasses
import enum


class SeparatorStyle(enum.Enum):
    SINGLE = enum.auto()
    TWO = enum.auto()
    MPT = enum.auto()
    PLAIN = enum.auto()
    LLAMA_2 = enum.auto()


@dataclasses.dataclass
class Conversation:
    system: str
    roles: tuple[str, str]
    messages: list[list[str | None]]
    offset: int = 0
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: str | None = None
    version: str = "unknown"

    def get_prompt(self) -> str:
        messages = [list(m) for m in self.messages]
        # first message carrying an (text, image, ...) tuple: inline <image>
        if messages and isinstance(messages[0][1], tuple):
            init_role, init_msg = messages[0]
            text = init_msg[0].replace("<image>", "").strip()
            messages[0] = [init_role, "<image>\n" + text]

        style = self.sep_style
        if style == SeparatorStyle.SINGLE:
            out = self.system + self.sep
            for role, message in messages:
                if message:
                    out += f"{role}: {_text(message)}{self.sep}"
                else:
                    out += f"{role}:"
            return out
        if style == SeparatorStyle.TWO:
            seps = (self.sep, self.sep2)
            out = self.system + seps[0]
            for i, (role, message) in enumerate(messages):
                if message:
                    out += f"{role}: {_text(message)}{seps[i % 2]}"
                else:
                    out += f"{role}:"
            return out
        if style == SeparatorStyle.MPT:
            out = self.system + self.sep
            for role, message in messages:
                out += f"{role}{_text(message)}{self.sep}" if message else role
            return out
        if style == SeparatorStyle.PLAIN:
            seps = (self.sep, self.sep2)
            out = self.system
            for i, (role, message) in enumerate(messages):
                if message:
                    out += _text(message) + seps[i % 2]
            return out
        if style == SeparatorStyle.LLAMA_2:
            out = ""
            for i, (role, message) in enumerate(messages):
                if not message:
                    continue
                text = _text(message)
                if i == 0:
                    text = f"<<SYS>>\n{self.system}\n<</SYS>>\n\n" + text
                if i % 2 == 0:
                    out += f"{self.sep}[INST] {text} [/INST]"
                else:
                    out += f" {text} {self.sep2}"
            return out.lstrip(self.sep)
        raise ValueError(style)

    def append_message(self, role: str, message: str | None) -> None:
        self.messages.append([role, message])

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system, roles=self.roles,
            messages=[list(m) for m in self.messages], offset=self.offset,
            sep_style=self.sep_style, sep=self.sep, sep2=self.sep2,
            version=self.version,
        )


def _text(message) -> str:
    return message[0] if isinstance(message, tuple) else message


conv_vicuna_v0 = Conversation(
    system="A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("Human", "Assistant"), messages=[], sep_style=SeparatorStyle.SINGLE,
    sep="###", version="v0",
)

conv_vicuna_v1 = Conversation(
    system="A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's questions.",
    roles=("USER", "ASSISTANT"), messages=[], sep_style=SeparatorStyle.TWO,
    sep=" ", sep2="</s>", version="v1",
)

conv_flant5 = Conversation(
    system="", roles=("USER", "ASSISTANT"), messages=[],
    sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>", version="v1",
)

conv_llama_2 = Conversation(
    system="You are a helpful, respectful and honest assistant.",
    roles=("USER", "ASSISTANT"), messages=[],
    sep_style=SeparatorStyle.LLAMA_2, sep="<s>", sep2="</s>", version="llama_v2",
)

conv_plain = Conversation(
    system="", roles=("", ""), messages=[], sep_style=SeparatorStyle.PLAIN,
    sep="\n", sep2="\n", version="plain",
)

conv_lstp = Conversation(
    system="", roles=("USER", "ASSISTANT"), messages=[],
    sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>", version="lstp",
)

conv_mpt = Conversation(
    system="<|im_start|>system\nA conversation between a user and an LLM-based "
    "AI assistant. The assistant gives helpful and honest answers.",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    messages=[], sep_style=SeparatorStyle.MPT, sep="<|im_end|>", version="mpt",
)

conv_llava_v0 = Conversation(
    system="A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("Human", "Assistant"), messages=[], sep_style=SeparatorStyle.SINGLE,
    sep="###", version="v0",
)

conv_llava_v1 = Conversation(
    system="A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("USER", "ASSISTANT"), messages=[], sep_style=SeparatorStyle.TWO,
    sep=" ", sep2="</s>", version="v1",
)

conv_templates = {
    "default": conv_vicuna_v1,
    "v0": conv_vicuna_v0,
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llama_2": conv_llama_2,
    "plain": conv_plain,
    "v0_plain": conv_plain,
    "llava_v0": conv_llava_v0,
    "llava_v1": conv_llava_v1,
    "flant5": conv_flant5,
    "mpt": conv_mpt,
    "lstp": conv_lstp,
}

default_conversation = conv_vicuna_v1
