"""Config schema: the model architecture fields the port's dense, MoE,
VLM, RWKV, hybrid and encoder-decoder families read, and the four
input-shape cells, with the reference's names and defaults
(``repro.configs.base``)."""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.engine.spec import QuantSpec

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "pad_vocab"]


def pad_vocab(v: int, multiple: int = 128) -> int:
    """Round vocab up to a multiple (the reference's padded vocabulary)."""
    return -(-v // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | vlm | rwkv | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int                # raw (pre-padding) vocabulary
    head_dim: int = 0              # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # 'expert' (EP) or 'mlp' (TP over d_ff): how the reference shards the
    # experts over a mesh; one device reads nothing of it
    moe_shard: str = "expert"
    moe_dispatch_groups: int = 1   # >1: tokens dispatched in groups
    router_aux_coef: float = 0.01
    # --- RWKV / SSM ---
    rwkv_head_size: int = 0
    ssm_state: int = 0             # the SSM's state size n a channel
    ssm_expand: int = 2            # d_inner = ssm_expand * d_model
    ssm_conv: int = 4              # the causal conv's width K
    # --- encoder-decoder ---
    n_encoder_layers: int = 0      # encoder blocks (n_layers: decoder's)
    # modality frontend (the VLM and encoder-decoder families' stub:
    # precomputed embeddings)
    frontend: Optional[str] = None  # 'vision' | 'audio'
    frontend_tokens: int = 0        # patches / frames per example
    qkv_bias: bool = False
    act: str = "silu"
    gated_mlp: bool = True
    rope_theta: float = 1e4
    norm: str = "rms"              # rms | layer
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    dtype: str = "bfloat16"        # compute dtype
    param_dtype: str = "float32"
    attn_chunk: int = 2048         # switch to flash-chunked above this seq
    # quantized-GEMM configuration; None runs the bf16 matmul path
    quant: Optional[QuantSpec] = None
    # long-context support (sub-quadratic sequence mixing)
    subquadratic: bool = False

    def quant_spec(self) -> Optional[QuantSpec]:
        """The QuantSpec the model layers execute under (None: bf16)."""
        if self.quant is not None and self.quant.enabled:
            return self.quant
        return None

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), as the
        reference counts it: an RWKV block's mixing stands at 6 d x d
        (no LoRA, decay or norm counted); a hybrid block counts its
        attention and MLP only (no SSM branch, no meta tokens); an
        encoder-decoder counts n_layers + n_encoder_layers such blocks
        (no cross-attention, no frontend projection)."""
        d, hd = self.d_model, self.resolved_head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        if self.family == "rwkv":
            attn = 5 * d * d + d * d  # r,k,v,w(g) projections + out
        mlp = (3 if self.gated_mlp else 2) * d * self.d_ff
        if self.n_experts:
            mlp = mlp * self.n_experts + d * self.n_experts
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        return (self.n_layers + self.n_encoder_layers) * (attn + mlp) + emb

    def active_param_count(self) -> int:
        """Parameters a token reaches: k experts' MLPs in place of all."""
        if not self.n_experts:
            return self.param_count()
        dense_like = self.replace(n_experts=0, d_ff=self.d_ff *
                                  self.experts_per_token)
        return dense_like.param_count()


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str           # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
