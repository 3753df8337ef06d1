"""The port's measurement scripts and replica calibrators, counterparts of
the JAX package's scripts/bench_*.py and scripts/calibrate_*.py, and
bench_window.py, the port's own (the bench's spread against the length
of its timed window); each runs
as `python -m gmeta_tpu_torch.scripts.<name>` on the card unless given
`--device cpu`. The measurement scripts write their JSON under
measure_torch/, the calibrators under parity_torch/cal/."""
