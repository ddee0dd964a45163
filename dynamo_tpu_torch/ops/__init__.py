"""Attention ops: plain PyTorch versions (attention.py) and the CUDA kernel
wrappers (cuda_attention, cuda_prefill, cuda_unified) built from csrc/; the
int8 KV format (quant.py) and the block-copy kernel's wrappers
(block_copy.py)."""
