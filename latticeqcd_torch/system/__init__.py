"""Port of latticeqcd_tpu/system."""
