"""BFP numerics, quantization configs, smoothing and the packed KV cache."""
