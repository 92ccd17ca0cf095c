"""Architecture configuration of the LM zoo: the same dataclass as
`repro.models.config`, copied whole (it is pure data)."""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple


class BlockKind(str, enum.Enum):
    ATTN = "attn"          # global attention + FFN
    LOCAL_ATTN = "local"   # sliding-window attention + FFN
    MOE = "moe"            # attention + MoE FFN
    MLSTM = "mlstm"        # xLSTM matrix-memory block
    SLSTM = "slstm"        # xLSTM scalar-memory block
    RGLRU = "rglru"        # RecurrentGemma RG-LRU block


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # Attention variants
    sliding_window: Optional[int] = None
    local_global_pattern: Optional[int] = None  # e.g. 2 → every 2nd layer global
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    # MoE
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    # Recurrent blocks
    block_pattern: Optional[Tuple[str, ...]] = None  # cycle of BlockKind values
    conv_width: int = 4            # recurrentgemma temporal conv
    lru_width: Optional[int] = None
    # Encoder-decoder (seamless-m4t)
    encoder_layers: int = 0        # >0 → enc-dec; n_layers = decoder layers
    # Modality frontend stubs
    n_vision_tokens: int = 0       # vlm: precomputed patch embeddings
    audio_frames: int = 0          # audio: precomputed frame embeddings
    # Numerics / training
    dtype: str = "float32"
    remat: bool = True
    tie_embeddings: bool = False
    # Paper technique hooks
    stream_weights: bool = False   # out-of-core expert/embedding streaming

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def blocks(self) -> List[BlockKind]:
        """Per-layer block kinds for the decoder stack."""
        if self.block_pattern:
            pat = [BlockKind(b) for b in self.block_pattern]
            return [pat[i % len(pat)] for i in range(self.n_layers)]
        if self.is_moe:
            return [BlockKind.MOE] * self.n_layers
        if self.local_global_pattern:
            # gemma2: alternating local/global, local first
            return [
                BlockKind.LOCAL_ATTN
                if (i % self.local_global_pattern) != self.local_global_pattern - 1
                else BlockKind.ATTN
                for i in range(self.n_layers)
            ]
        if self.sliding_window:
            return [BlockKind.LOCAL_ATTN] * self.n_layers
        return [BlockKind.ATTN] * self.n_layers

    @property
    def subquadratic(self) -> bool:
        """True if the arch can decode at 500k context (SSM/hybrid/linear)."""
        kinds = set(self.blocks())
        quad = {BlockKind.ATTN, BlockKind.MOE}
        if self.is_enc_dec:
            return False
        return not (kinds & quad) or kinds <= {
            BlockKind.MLSTM, BlockKind.SLSTM, BlockKind.RGLRU,
            BlockKind.LOCAL_ATTN}

    def scaled_down(self, **overrides) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            head_dim=16,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            expert_d_ff=64 if self.expert_d_ff else 0,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else None,
            encoder_layers=min(self.encoder_layers, 2) if self.encoder_layers else 0,
            n_vision_tokens=min(self.n_vision_tokens, 8) if self.n_vision_tokens else 0,
            audio_frames=min(self.audio_frames, 16) if self.audio_frames else 0,
            lru_width=64 if self.lru_width else None,
            remat=False,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)
