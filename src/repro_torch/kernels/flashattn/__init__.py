"""Flash-attention forward: K3 (bf16 K/V) and K4 (packed digit-plane K/V)."""
