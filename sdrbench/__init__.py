"""The benchmark of supersdr_tpu_torch: `python3 -m sdrbench.run`."""
