"""Port of latticeqcd_tpu/updates."""
