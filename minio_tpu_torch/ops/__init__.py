"""Device math for the erasure and SSE hot paths: GF(256) tables and
matrices (numpy, host), the bit-sliced Reed-Solomon codec, MUR3X256,
HighwayHash-256 and ChaCha20 (plain PyTorch), and their hand-written Hopper
kernels (CUDA C++, loaded with ctypes)."""
