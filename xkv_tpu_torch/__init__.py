"""PyTorch/CUDA port of xkv_tpu: cross-layer SVD KV-cache compression
served on NVIDIA Hopper through hand-written CUDA kernels."""
