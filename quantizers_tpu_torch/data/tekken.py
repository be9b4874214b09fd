"""Native tekken (Mistral) tokenizer.

The reference reaches Mistral's tekken tokenizer through the
``mistral-common`` package (``scripts/old_scripts/main_devstral-gptq.py:13-14,145-148``)
— that dependency isn't available here, so this is a first-party reader
for the public ``tekken.json`` format: a byte-level BPE defined by ranked
token byte strings (tiktoken-style greedy merging), plus a special-token
table and a simple chat template (``[INST] ... [/INST]``).

Covers the capability surface the reference exercises: load from a model
directory, ``apply_chat_template``, ``__call__`` with truncation — the
two entry points CalibrationSet tokenization uses.

A copy of ``quantizers_tpu/data/tekken.py`` (standard library only).
"""

from __future__ import annotations

import base64
import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

# GPT-style pre-tokenization: greedy BPE is O(n^2) in piece length, so
# text is split into word-sized pieces first (the real tekken does the
# same with a near-identical pattern)
_PRETOK = re.compile(
    r"[^\r\n\w]?\w+|\d{1,3}| ?[^\s\w]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")


class TekkenTokenizer:
    """Minimal tekken.json byte-level BPE."""

    def __init__(self, path: Union[str, Path]):
        data = json.loads(Path(path).read_text())
        cfg = data.get("config", {})
        self.num_special = int(cfg.get("default_num_special_tokens", 1000))
        limit = cfg.get("default_vocab_size")
        vocab = data.get("vocab", [])
        if limit:
            vocab = vocab[: int(limit) - self.num_special]
        # rank -> bytes and bytes -> rank (ranks are pre-special-offset)
        self._rank_bytes: List[bytes] = []
        self._ranks: Dict[bytes, int] = {}
        for i, entry in enumerate(vocab):
            b = base64.b64decode(entry["token_bytes"])
            self._rank_bytes.append(b)
            self._ranks.setdefault(b, i)
        self.special_tokens: Dict[str, int] = {}
        for i, entry in enumerate(data.get("special_tokens", [])):
            if isinstance(entry, dict):
                self.special_tokens[entry.get("token_str", f"<special_{i}>")] = (
                    int(entry.get("rank", i)))
            else:
                self.special_tokens[str(entry)] = i
        self.bos_id = self.special_tokens.get("<s>", 1)
        self.eos_id = self.special_tokens.get("</s>", 2)

    @property
    def vocab_size(self) -> int:
        return self.num_special + len(self._rank_bytes)

    # -- BPE core ----------------------------------------------------------
    def _bpe(self, piece: bytes) -> List[int]:
        parts: List[bytes] = [piece[i:i + 1] for i in range(len(piece))]
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                r = self._ranks.get(parts[i] + parts[i + 1])
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            parts[best_i:best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        out = []
        for p in parts:
            r = self._ranks.get(p)
            if r is None:  # unmergeable byte not in vocab: skip
                continue
            out.append(self.num_special + r)
        return out

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids = [self.bos_id] if add_bos else []
        for piece in _PRETOK.findall(text):
            ids.extend(self._bpe(piece.encode("utf-8")))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        buf = b""
        for t in ids:
            t = int(t)
            if t < self.num_special:
                continue
            r = t - self.num_special
            if 0 <= r < len(self._rank_bytes):
                buf += self._rank_bytes[r]
        return buf.decode("utf-8", errors="replace")

    # -- HF-compatible surface used by CalibrationSet ----------------------
    def apply_chat_template(self, messages, tokenize: bool = False,
                            add_generation_prompt: bool = False):
        """``[INST] ... [/INST]`` template. With ``tokenize=True`` the
        instruction markers and turn terminators are emitted as their
        *reserved special-token ids* (tekken reserves the first
        ``num_special`` ranks for them) — byte-BPE-ing the marker text
        would tokenize every sequence off-distribution and eos would
        never equal ``eos_id``."""
        # (marker text, fallback when the id table lacks it)
        inst = self.special_tokens.get("[INST]")
        inst_end = self.special_tokens.get("[/INST]")
        segs: List = []  # str (text to BPE) or int (special id)

        def mark(tok_id, literal):
            segs.append(tok_id if tok_id is not None else literal)

        sys_txt = ""
        for m in messages:
            role, content = m.get("role"), m.get("content", "")
            if role == "system":
                sys_txt = content
            elif role == "user":
                body = f"{sys_txt}\n\n{content}" if sys_txt else content
                sys_txt = ""
                mark(inst, "[INST]")
                segs.append(f" {body} ")
                mark(inst_end, "[/INST]")
            elif role == "assistant":
                segs.append(content)
                mark(self.eos_id, "</s>")
        if not tokenize:
            out = []
            for s in segs:
                if isinstance(s, int):
                    inv = {v: k for k, v in self.special_tokens.items()}
                    out.append(inv.get(s, "</s>" if s == self.eos_id else ""))
                else:
                    out.append(s)
            return "".join(out)
        ids = [self.bos_id]
        for s in segs:
            if isinstance(s, int):
                ids.append(s)
            else:
                ids.extend(self._bpe_text(s))
        return ids

    def _bpe_text(self, text: str) -> List[int]:
        out: List[int] = []
        for piece in _PRETOK.findall(text):
            out.extend(self._bpe(piece.encode("utf-8")))
        return out

    def __call__(self, text: str, max_length: Optional[int] = None,
                 truncation: bool = False, padding: bool = False,
                 add_special_tokens: bool = True):
        ids = self.encode(text, add_bos=bool(add_special_tokens))
        if truncation and max_length is not None:
            ids = ids[:max_length]
        return {"input_ids": ids, "attention_mask": [1] * len(ids)}

    def save_pretrained(self, out_dir: Union[str, Path]) -> None:
        # carried by file copy at the CLI layer; nothing internal to write
        Path(out_dir).mkdir(parents=True, exist_ok=True)
