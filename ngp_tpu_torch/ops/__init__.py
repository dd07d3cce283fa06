"""L0/L1 ops: rays, encoders, activations, the CP grid and the kernels."""
