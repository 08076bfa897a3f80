"""Port of latticeqcd_tpu/md."""
