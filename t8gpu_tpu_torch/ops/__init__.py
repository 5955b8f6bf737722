"""Field and flux math, stage glue, and the CUDA kernels."""
