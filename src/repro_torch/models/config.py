"""Unified model configuration covering all assigned architecture families.

A copy of ``repro.models.config``, so that a configuration carries over
field for field. The port's model runs the attention families (dense, moe,
audio, vlm) and rejects the recurrent ones it does not implement yet
(``repro_torch.models.model.check_supported``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | audio | vlm | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 1024              # GShard routing group

    # attention variants
    sliding_window: Optional[int] = None    # SWA window (mixtral, gemma2 local)
    local_global: bool = False              # gemma2: even layers local, odd global
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False

    # ssm / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    block_kinds: Tuple[str, ...] = ()       # per-layer: attn|mlstm|slstm|mamba
    shared_attn_every: int = 0              # zamba2: shared attn after every N

    # modality frontend stub
    input_mode: str = "tokens"              # tokens | embeddings

    # sub-quadratic / bounded-cache decode => long_500k cell applies
    long_context_ok: bool = False

    norm_eps: float = 1e-5

    # quantization of GEMM operands (the paper's technique)
    quant: str = "none"                     # none | qat | serve
    quant_format: str = "m2xfp"             # any codecs.packed_codecs()
    kv_quant: str = "none"     # none | any codecs.kv_codecs() (Sec. 6.4)

    # distribution hints
    remat: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def kinds(self) -> Tuple[str, ...]:
        if self.block_kinds:
            return self.block_kinds
        return ("attn",) * self.n_layers

    @property
    def n_params(self) -> int:
        """Total parameter count (embeddings included once if tied)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd, nh, nkv = self.hd, self.n_heads, self.n_kv_heads
        total = v * d * (1 if self.tie_embeddings else 2)
        for kind in self.kinds:
            if kind == "attn":
                total += d * hd * (nh + 2 * nkv) + nh * hd * d  # qkv + o
                total += self._ffn_params()
                total += 2 * d                                   # norms
            elif kind == "mamba":
                total += self._mamba_params()
            elif kind == "mlstm":
                total += self._mlstm_params()
            elif kind == "slstm":
                total += self._slstm_params()
        if self.shared_attn_every:
            d_attn = self.hd * self.n_heads
            total += d * d_attn * 3 + d_attn * d + self._shared_ffn_params()
        return total

    def _ffn_params(self) -> int:
        d, ff = self.d_model, self.d_ff
        if self.is_moe:
            router = d * self.n_experts
            return router + self.n_experts * 3 * d * ff
        return 3 * d * ff  # SwiGLU: gate, up, down

    def _shared_ffn_params(self) -> int:
        return 3 * self.d_model * self.d_ff

    def _mamba_params(self) -> int:
        d = self.d_model
        din = self.ssm_expand * d
        nheads = din // self.ssm_head_dim
        n = self.ssm_state
        # in_proj: z, x, B, C, dt ; conv ; A, D, dt_bias ; out_proj
        in_proj = d * (2 * din + 2 * n + nheads)
        conv = self.ssm_conv * (din + 2 * n)
        extras = 3 * nheads
        out_proj = din * d
        return in_proj + conv + extras + out_proj + 2 * d

    def _mlstm_params(self) -> int:
        d = self.d_model
        din = 2 * d
        h = self.n_heads
        return d * 2 * din + 4 * din + din * din // h * 3 + 3 * din + din * d + 2 * d

    def _slstm_params(self) -> int:
        d = self.d_model
        ff = int(d * 4 / 3)
        return 4 * d * d + 4 * d * d // self.n_heads + 4 * d + 2 * d * ff + 2 * d

    @property
    def active_params(self) -> int:
        """Active parameters per token (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.n_params
        d, ff = self.d_model, self.d_ff
        inactive = (self.n_experts - self.experts_per_token) * 3 * d * ff
        return self.n_params - inactive * sum(
            1 for k in self.kinds if k == "attn")
