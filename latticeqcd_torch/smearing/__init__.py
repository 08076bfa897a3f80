"""Port of latticeqcd_tpu/smearing: the gradient flow and stout smearing."""
