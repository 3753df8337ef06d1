"""The port's measurement scripts, counterparts of the JAX package's
scripts/bench_*.py; each runs as `python -m gmeta_tpu_torch.scripts.<name>`
on the card unless given `--device cpu`, and writes its JSON under
measure_torch/."""
