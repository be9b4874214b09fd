"""Chat-format converters for calibration data.

Counterpart of ``quantizers_tpu/data/formatters.py``, the same code.

Re-implements the converter surface of the reference's formatter layer
(reference ``src/quantizers/formatters.py:26-308``): six converters that turn
raw dataset rows into chat-completion message lists
``[{"role": ..., "content": ...}, ...]``, each column-name agnostic and
strict about the number of columns it receives.

Formatters are plain functions registered through :func:`formatter`; the
``DatasetFmt`` namespace is kept for API compatibility with the reference's
``DatasetFmt.get_formatter(name)`` call sites.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

log = logging.getLogger(__name__)

Message = Dict[str, str]
FormatterFn = Callable[..., List[Message]]

_REGISTRY: Dict[str, FormatterFn] = {}

_CHAT_ROLES = ("system", "user", "assistant", "tool")


def formatter(name: str) -> Callable[[FormatterFn], FormatterFn]:
    """Register a converter under ``name``."""

    def deco(fn: FormatterFn) -> FormatterFn:
        _REGISTRY[name] = fn
        return fn

    return deco


def get_formatter(name: str) -> FormatterFn:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"Unknown formatter: {name}") from None


def available_formatters() -> List[str]:
    return sorted(_REGISTRY)


def _require_columns(fmt_name: str, columns: List[str], expected: int) -> None:
    if len(columns) != expected:
        raise ValueError(
            f"{fmt_name} format requires exactly {expected} "
            f"column{'s' if expected != 1 else ''}, got {len(columns)}: {columns}"
        )


@formatter("sharegpt")
def sharegpt(columns: List[str], data: Dict[str, Any]) -> List[Message]:
    """ShareGPT turns (``from``/``value`` with human/gpt/system senders).

    Unknown senders default to ``user``; structurally invalid entries are
    skipped with a warning. (Reference behavior: ``formatters.py:91-127``.)
    """
    _require_columns("ShareGPT", columns, 1)
    turns = data[columns[0]]
    sender_to_role = {"human": "user", "gpt": "assistant", "system": "system"}

    out: List[Message] = []
    for idx, turn in enumerate(turns):
        if not (isinstance(turn, dict) and "from" in turn and "value" in turn):
            log.warning("Skipping invalid conversation entry %d: %r", idx, turn)
            continue
        role = sender_to_role.get(turn.get("from", ""), "user")
        out.append({"role": role, "content": turn.get("value", "")})
    return out


@formatter("prompt_answer")
def prompt_answer(columns: List[str], data: Dict[str, Any]) -> List[Message]:
    """Two arbitrary columns -> one user turn + one assistant turn.

    Empty/falsy values drop their turn. (Reference: ``formatters.py:129-161``.)
    """
    _require_columns("Prompt-answer", columns, 2)
    prompt, answer = data[columns[0]], data[columns[1]]
    out: List[Message] = []
    if prompt:
        out.append({"role": "user", "content": prompt})
    if answer:
        out.append({"role": "assistant", "content": answer})
    return out


@formatter("chat_completion")
def chat_completion(columns: List[str], data: Dict[str, Any]) -> List[Message]:
    """Pass-through of an existing message list.

    Messages carrying a non-empty ``reasoning_content`` are folded into the
    assistant content as ``<think>...</think>`` so the reasoning trace
    survives ``apply_chat_template``. (Reference: ``formatters.py:163-196``.)
    """
    _require_columns("Chat completion", columns, 1)
    out: List[Message] = []
    for msg in data[columns[0]]:
        reasoning = msg.get("reasoning_content") if isinstance(msg, dict) else None
        if reasoning:
            if msg.get("role") != "assistant":
                raise AssertionError(f"Invalid chat_completion entry: {msg}")
            merged = f"<think>{reasoning}</think>\n{msg.get('content', '')}"
            out.append({"role": "assistant", "content": merged})
        elif isinstance(msg, dict) and "reasoning_content" in msg:
            out.append({"role": msg["role"], "content": msg["content"]})
        else:
            out.append(msg)
    return out


@formatter("chat_completion_with_sysprompt")
def chat_completion_with_sysprompt(columns: List[str], data: Dict[str, Any]) -> List[Message]:
    """System prompt column + conversation column (ToolACE-style).

    Accepts both ``from``/``value`` and ``role``/``content`` message shapes;
    messages with unknown roles are skipped with a warning.
    (Reference: ``formatters.py:26-89``.)
    """
    _require_columns("Chat completion with system prompt", columns, 2)
    system_prompt = data[columns[0]]
    conversation = data[columns[1]]

    out: List[Message] = []
    if system_prompt:
        out.append({"role": "system", "content": system_prompt})

    for msg in conversation or []:
        if not isinstance(msg, dict):
            continue
        if "from" in msg and "value" in msg:
            role, content = msg.get("from", ""), msg.get("value", "")
        elif "role" in msg and "content" in msg:
            role, content = msg["role"], msg["content"]
        else:
            continue
        if role in _CHAT_ROLES:
            out.append({"role": role, "content": content})
        else:
            log.warning("Skipping message with unknown role: %s", role)
    return out


@formatter("raw_text")
def raw_text(columns: List[str], data: Dict[str, Any], prefix: Optional[str] = None) -> List[Message]:
    """Raw text as a single assistant turn, optionally preceded by a user
    ``prefix`` turn (used with Jinja-templated prefixes in calibration-set
    configs). (Reference: ``formatters.py:226-257``.)
    """
    _require_columns("Raw text", columns, 1)
    out: List[Message] = []
    if prefix:
        out.append({"role": "user", "content": prefix})
    out.append({"role": "assistant", "content": data[columns[0]]})
    return out


@formatter("deepmind_code_contests")
def deepmind_code_contests(columns: List[str], data: Dict[str, Any]) -> List[Message]:
    """DeepMind code_contests rows: description -> user, first solution ->
    assistant. If the selected column holds plain text, fall back to the whole
    row for structure. (Reference: ``formatters.py:259-308``.)
    """
    _require_columns("DeepMind Code Contests", columns, 1)
    row = data[columns[0]]
    if isinstance(row, str):
        row = data

    out: List[Message] = []
    description = row.get("description", "")
    if description:
        out.append({"role": "user", "content": description})

    solutions = row.get("solutions") or {}
    codes = solutions.get("solution") if isinstance(solutions, dict) else None
    if codes:
        out.append({"role": "assistant", "content": codes[0]})
    return out


class DatasetFmt:
    """Namespace kept API-compatible with the reference's ``DatasetFmt``."""

    sharegpt = staticmethod(sharegpt)
    prompt_answer = staticmethod(prompt_answer)
    chat_completion = staticmethod(chat_completion)
    chat_completion_with_sysprompt = staticmethod(chat_completion_with_sysprompt)
    raw_text = staticmethod(raw_text)
    deepmind_code_contests = staticmethod(deepmind_code_contests)

    get_formatter = staticmethod(get_formatter)
    available_formatters = staticmethod(available_formatters)
