"""Sort engines, the public dispatcher and the CUDA kernel binding."""
