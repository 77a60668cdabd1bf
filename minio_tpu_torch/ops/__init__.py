"""Device math for the erasure, SSE and S3 Select hot paths: GF(256) tables
and matrices (numpy, host), the bit-sliced Reed-Solomon codec, MUR3X256,
HighwayHash-256, ChaCha20 and the CSV predicate scan (plain PyTorch), and
their hand-written Hopper kernels (CUDA C++, loaded with ctypes)."""
