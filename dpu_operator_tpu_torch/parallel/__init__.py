"""Kernels and codecs of the port: the fused paged-attention step
(``paged_attn``) and the block-axis int8 codec (``quantize``)."""
