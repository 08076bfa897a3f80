"""Port of latticeqcd_tpu/smearing: the gradient flow (stout smearing waits for ROADMAP A12)."""
