"""Tools of racon_tpu_torch."""
