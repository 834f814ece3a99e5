"""Sketches of k-mer sets: HyperLogLog, CSetSketch, multi-k counts and
exact set comparison (``bonsai_tpu/sketch/``: hll, setsketch, shs,
compare)."""
