"""Port of latticeqcd_tpu/ops."""
