"""Hand-written CUDA kernels (sm_90a) of the port, built at first use."""
