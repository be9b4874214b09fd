"""Model architecture specs.

One :class:`ModelSpec` dataclass describes every decoder-only architecture
the reference's configs target (Qwen3 dense `configs/test-quantize_qwen3-4b-awq.yaml`,
Qwen3-30B-A3B MoE `configs/test-quantize_qwen3_30b_a3b_nvfp4.yaml`, plus the
Llama/Mistral-shaped models of the historical scripts). ``from_hf_config``
parses a HuggingFace ``config.json`` dict so local checkpoints load without
transformers being importable.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional, Union


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static architecture description (hashable — safe as a jit static arg)."""

    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    max_position_embeddings: int = 32768
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    mlp_bias: bool = False
    # Qwen3-style per-head RMSNorm on Q/K.
    qk_norm: bool = False
    # --- MLA (DeepSeek-V2/V3 / GLM-Flash / MiniMax family) ---
    # kv_lora_rank > 0 switches the attention block to MLA: low-rank
    # compressed KV + decoupled RoPE head (the projections the reference's
    # data-free script keeps high-precision, `quant_GLM-4.7-Flash-FP8.py:15-22`)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0
    # --- MoE (qwen3_moe-style); num_experts == 0 means dense ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    norm_topk_prob: bool = True
    # DeepSeek-style extras: always-on shared experts + sigmoid scoring
    # with a learned correction bias and routed scaling
    num_shared_experts: int = 0
    scoring_func: str = "softmax"  # softmax | sigmoid
    routed_scaling_factor: float = 1.0
    # layers whose MLP is dense even in an MoE model (qwen3_moe's
    # `mlp_only_layers` / `decoder_sparse_step`; deepseek's
    # `first_k_dense_replace` maps onto mlp_only_layers)
    decoder_sparse_step: int = 1
    mlp_only_layers: tuple = ()
    model_type: str = "qwen3"

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def qk_head_dim(self) -> int:
        return (self.qk_nope_head_dim + self.qk_rope_head_dim) if self.is_mla else self.head_dim

    def kv_cache_dims(self):
        """((heads_k, hd_k), (heads_v, hd_v)) of the decode cache.

        MLA stores the *latent* cache (DeepSeek absorbed form): the "k"
        array holds the shared kv_lora_rank compression per token and the
        "v" array holds the shared post-rope k_pe head padded to a lane
        multiple — r + rope_pad elements per token instead of
        num_heads*(qk_head_dim + v_head_dim), ~H× smaller."""
        if self.is_mla:
            rope_pad = -(-max(self.qk_rope_head_dim, 1) // 128) * 128
            return ((1, self.kv_lora_rank), (1, rope_pad))
        return ((self.num_kv_heads, self.head_dim),
                (self.num_kv_heads, self.head_dim))

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def layer_is_moe(self, layer_idx: int) -> bool:
        if not self.is_moe:
            return False
        if layer_idx in self.mlp_only_layers:
            return False
        step = max(1, self.decoder_sparse_step)
        return (layer_idx + 1) % step == 0 if step > 1 else True

    def layer_kind(self, layer_idx: int):
        """The AUTHORITATIVE per-layer semantic key: two layers with equal
        ``layer_kind`` must trace to identical ``apply_layer`` programs.

        The oneshot engine shares compiled capture/propagate programs
        across same-kind layers (``engine._canonical_layer_idx``); any
        future per-layer-index behavior — sliding-window-every-Nth,
        NoPE-every-Nth, per-layer rope scaling — MUST extend this tuple,
        or same-kind sharing would silently calibrate every layer with the
        first layer's semantics. Guarded by a jaxpr-equality test
        (tests/test_oneshot.py::test_layer_kind_is_trace_authoritative)."""
        return (self.layer_is_moe(layer_idx),)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    # ------------------------------------------------------------------
    @classmethod
    def from_hf_config(cls, cfg: Union[Dict[str, Any], str, Path]) -> "ModelSpec":
        """Build from a HF ``config.json`` dict or a path to one / its dir."""
        if not isinstance(cfg, dict):
            p = Path(cfg)
            if p.is_dir():
                p = p / "config.json"
            cfg = json.loads(p.read_text())
        # Some checkpoints nest the text config (VLMs).
        if "text_config" in cfg and "hidden_size" not in cfg:
            cfg = {**cfg["text_config"], "model_type": cfg.get("model_type", "")}

        model_type = cfg.get("model_type", "qwen3")
        hidden = int(cfg["hidden_size"])
        heads = int(cfg["num_attention_heads"])
        head_dim = int(cfg.get("head_dim") or hidden // heads)
        moe = "moe" in model_type or cfg.get("num_experts") or cfg.get("n_routed_experts")
        num_experts = int(cfg.get("num_experts") or cfg.get("n_routed_experts") or 0) if moe else 0
        kv_lora = int(cfg.get("kv_lora_rank") or 0)
        first_dense = int(cfg.get("first_k_dense_replace") or 0)
        mlp_only = tuple(cfg.get("mlp_only_layers") or range(first_dense))

        return cls(
            vocab_size=int(cfg["vocab_size"]),
            hidden_size=hidden,
            num_layers=int(cfg["num_hidden_layers"]),
            num_heads=heads,
            num_kv_heads=int(cfg.get("num_key_value_heads") or heads),
            head_dim=head_dim,
            intermediate_size=int(cfg["intermediate_size"]),
            rms_norm_eps=float(cfg.get("rms_norm_eps", 1e-6)),
            rope_theta=float(cfg.get("rope_theta", 1_000_000.0)),
            max_position_embeddings=int(cfg.get("max_position_embeddings", 32768)),
            tie_word_embeddings=bool(cfg.get("tie_word_embeddings", False)),
            attention_bias=bool(cfg.get("attention_bias", model_type.startswith("qwen2"))),
            qk_norm=model_type.startswith("qwen3"),
            q_lora_rank=int(cfg.get("q_lora_rank") or 0),
            kv_lora_rank=kv_lora,
            qk_rope_head_dim=int(cfg.get("qk_rope_head_dim") or 0),
            qk_nope_head_dim=int(cfg.get("qk_nope_head_dim") or 0),
            v_head_dim=int(cfg.get("v_head_dim") or 0),
            num_experts=num_experts,
            num_experts_per_tok=int(cfg.get("num_experts_per_tok") or cfg.get("top_k") or 0),
            moe_intermediate_size=int(cfg.get("moe_intermediate_size") or 0),
            norm_topk_prob=bool(cfg.get("norm_topk_prob", True)),
            num_shared_experts=int(cfg.get("n_shared_experts") or 0),
            scoring_func=str(cfg.get("scoring_func", "softmax")),
            routed_scaling_factor=float(cfg.get("routed_scaling_factor", 1.0)),
            decoder_sparse_step=int(cfg.get("decoder_sparse_step", 1)),
            mlp_only_layers=mlp_only,
            model_type=model_type,
        )

    def to_hf_config(self) -> Dict[str, Any]:
        """Emit a HF-compatible ``config.json`` dict (round-trips with
        :meth:`from_hf_config`; written into saved checkpoints)."""
        cfg: Dict[str, Any] = {
            "model_type": self.model_type,
            "architectures": [
                {"qwen3": "Qwen3ForCausalLM", "qwen3_moe": "Qwen3MoeForCausalLM",
                 "deepseek_v2": "DeepseekV2ForCausalLM",
                 "deepseek_v3": "DeepseekV3ForCausalLM"}.get(
                    self.model_type, "LlamaForCausalLM")
            ],
            "vocab_size": self.vocab_size,
            "hidden_size": self.hidden_size,
            "num_hidden_layers": self.num_layers,
            "num_attention_heads": self.num_heads,
            "num_key_value_heads": self.num_kv_heads,
            "head_dim": self.head_dim,
            "intermediate_size": self.intermediate_size,
            "rms_norm_eps": self.rms_norm_eps,
            "rope_theta": self.rope_theta,
            "max_position_embeddings": self.max_position_embeddings,
            "tie_word_embeddings": self.tie_word_embeddings,
            "attention_bias": self.attention_bias,
            "torch_dtype": "bfloat16",
        }
        if self.is_moe:
            cfg.update({
                "num_experts": self.num_experts,
                "num_experts_per_tok": self.num_experts_per_tok,
                "moe_intermediate_size": self.moe_intermediate_size,
                "norm_topk_prob": self.norm_topk_prob,
                "decoder_sparse_step": self.decoder_sparse_step,
                "mlp_only_layers": list(self.mlp_only_layers),
                "n_shared_experts": self.num_shared_experts,
                "scoring_func": self.scoring_func,
                "routed_scaling_factor": self.routed_scaling_factor,
            })
        if self.is_mla:
            cfg.update({
                "q_lora_rank": self.q_lora_rank or None,
                "kv_lora_rank": self.kv_lora_rank,
                "qk_rope_head_dim": self.qk_rope_head_dim,
                "qk_nope_head_dim": self.qk_nope_head_dim,
                "v_head_dim": self.v_head_dim,
            })
        return cfg

    # Handy tiny specs for tests / dry runs.
    @classmethod
    def tiny(cls, moe: bool = False, mla: bool = False, **over: Any) -> "ModelSpec":
        base = dict(
            vocab_size=256,
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            intermediate_size=128,
            qk_norm=True,
            rope_theta=10_000.0,
        )
        if moe:
            base.update(
                num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32,
                model_type="qwen3_moe",
            )
        if mla:
            base.update(
                qk_norm=False, num_kv_heads=base["num_heads"],
                q_lora_rank=32, kv_lora_rank=32, qk_rope_head_dim=8,
                qk_nope_head_dim=16, v_head_dim=16,
                model_type="deepseek_v3" if not moe else "deepseek_v3",
            )
            if moe:
                base.update(num_shared_experts=1, scoring_func="sigmoid",
                            routed_scaling_factor=2.5, mlp_only_layers=(0,))
        base.update(over)
        return cls(**base)
