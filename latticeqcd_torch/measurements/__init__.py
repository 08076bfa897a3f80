"""Port of latticeqcd_tpu/measurements."""
