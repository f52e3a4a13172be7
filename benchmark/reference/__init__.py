"""The plain float32 reference that decides a run's ``correct``: the
MS-UNet forward, the Dynamic loss and AdamW, in plain PyTorch, importing
nothing of the port or of JAX."""
