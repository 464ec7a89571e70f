"""Decoder model of the port (the attention families: dense, moe, audio,
vlm): config, numerics, layers, packed linear layers, the mixture-of-experts
FFN, attention over a per-slot KV cache (bf16 or packed), and the model."""
