"""Scene field, its CUDA kernels, samplers and the NeuS renderer."""
