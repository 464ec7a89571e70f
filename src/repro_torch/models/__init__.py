"""Dense decoder model of the port: config, numerics, layers, packed
linear layers, attention over a per-slot KV cache (bf16 or packed), and
the model."""
