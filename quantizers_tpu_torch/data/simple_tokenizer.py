"""Hermetic byte-level tokenizer.

Used when a model directory ships no tokenizer files (offline smoke runs,
CI, zero-egress environments) — implements exactly the two-method surface
``CalibrationSet.get_tokenized`` expects from a HF tokenizer
(reference tokenization call shape: ``calibration_sets.py:624-647``):
``apply_chat_template(messages, tokenize=False)`` and
``__call__(text, padding, max_length, truncation, add_special_tokens)``.

A copy of ``quantizers_tpu/data/simple_tokenizer.py`` (framework-free);
``transformers`` is imported only inside :func:`load_tokenizer`.
"""

from __future__ import annotations

from typing import Any, Dict, List


class ByteTokenizer:
    """UTF-8 bytes as token ids (vocab 256; ids offset by ``reserve``)."""

    def __init__(self, reserve: int = 2, vocab_size: int = 258) -> None:
        self.reserve = reserve
        self.vocab_size = vocab_size
        self.pad_token_id = 0
        self.eos_token_id = 1

    def apply_chat_template(self, messages: List[Dict[str, Any]],
                            tokenize: bool = False, **_: Any) -> str:
        parts = []
        for m in messages:
            parts.append(f"<|{m.get('role', 'user')}|>{m.get('content', '')}")
        text = "\n".join(parts)
        if tokenize:
            return self._encode(text)
        return text

    def _encode(self, text: str) -> List[int]:
        return [b + self.reserve for b in text.encode("utf-8")]

    def decode(self, ids: List[int]) -> str:
        data = bytes(max(0, i - self.reserve) % 256 for i in ids if i >= self.reserve)
        return data.decode("utf-8", errors="replace")

    def __call__(self, text: str, padding: bool = False,
                 max_length: int = None, truncation: bool = False,
                 add_special_tokens: bool = False, **_: Any) -> Dict[str, List[int]]:
        ids = self._encode(text)
        if truncation and max_length is not None:
            ids = ids[:max_length]
        return {"input_ids": ids, "attention_mask": [1] * len(ids)}

    def save_pretrained(self, out_dir: str) -> None:
        import json
        from pathlib import Path

        Path(out_dir).mkdir(parents=True, exist_ok=True)
        (Path(out_dir) / "tokenizer_config.json").write_text(json.dumps({
            "tokenizer_class": "ByteTokenizer",
            "note": "hermetic byte-level tokenizer (quantizers_tpu fallback)",
        }))


def load_tokenizer(model_dir: str):
    """AutoTokenizer when the directory ships one; ByteTokenizer otherwise."""
    from pathlib import Path

    p = Path(model_dir)
    has_tok = any((p / f).exists() for f in
                  ("tokenizer.json", "tokenizer.model", "tokenizer_config.json"))
    if has_tok:
        # an exact HF tokenizer beats the first-party tekken approximation
        # when a directory ships both (common for Mistral HF mirrors)
        try:
            from transformers import AutoTokenizer

            return AutoTokenizer.from_pretrained(str(p), trust_remote_code=True)
        except Exception:  # pragma: no cover - transformers quirks
            pass
    if (p / "tekken.json").exists():
        # tekken-only Mistral models (reference: mistral-common integration
        # in scripts/old_scripts/main_devstral-gptq.py:145-148)
        from .tekken import TekkenTokenizer

        return TekkenTokenizer(p / "tekken.json")
    return ByteTokenizer()
