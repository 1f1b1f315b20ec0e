"""Command-line tools of the port (the JAX repo's scripts/), run as
`python3 -m trident_tpu_torch.scripts.<name>`."""
