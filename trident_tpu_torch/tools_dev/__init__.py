"""Developer probes of the port on the card, the counterparts of the JAX
package's tools_dev/ scripts: kbench (the visibility kernel's cost split
and the binning chain), gather_probe (a LUT gather beside torch.gather)
and diag_split_kernel (the split-bf16 select). Each runs as
`python -m trident_tpu_torch.tools_dev.<name>`, on the card unless
`--device cpu` is passed. timing and scenes hold the helpers they share
with chip_smoke.py.
"""
