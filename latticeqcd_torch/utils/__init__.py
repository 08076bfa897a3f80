"""Port of latticeqcd_tpu/utils."""
