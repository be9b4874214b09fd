"""Model layer: the decoder-only transformer (dense and MoE) over QuantLinear dicts."""

from .config import ModelSpec  # noqa: F401
from .moe import ExpertLinears, moe_forward, route_topk, route_topk_sparse  # noqa: F401
from .transformer import (  # noqa: F401
    KVCache,
    apply_layer,
    embed,
    forward,
    fuse_for_decode,
    init_params,
    logits_head,
    quantize_lm_head,
)
from .loader import load_compressed_model, load_hf_model  # noqa: F401
