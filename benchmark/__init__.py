"""The benchmark of anemoi_tpu_torch on the card: see README.md."""
