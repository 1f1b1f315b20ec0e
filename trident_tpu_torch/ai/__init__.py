"""Neural nets of the renderer (port of trident_tpu/ai)."""
