"""minio_tpu_torch — the PyTorch/CUDA port of minio_tpu for NVIDIA Hopper.

It mirrors the JAX package's layout and names so each module's
counterpart is easy to find:

- ``minio_tpu_torch.ops``      GF(256) host math, the Reed-Solomon codec
  (``rs_torch``), MUR3X256 (``mur3_torch``), HighwayHash-256 (``hh_torch``),
  ChaCha20 (``chacha_torch``), the S3 Select CSV scan (``scan_torch``), their
  hand-written CUDA kernels (``rs_cuda``, ``mur3_cuda``, ``hh_cuda``,
  ``chacha_cuda``, ``scan_cuda``, sources under ``csrc/``) and the fused
  encode+hash / verify+rebuild launches (``fused``)
- ``minio_tpu_torch.erasure``  codec wrapper, bitrot framing, streaming
  encode / decode / heal
- ``minio_tpu_torch.crypto``   SSE-C with the ChaCha20-Poly1305 package
  cipher (EncryptReader / DecryptWriter)
- ``minio_tpu_torch.s3select`` SelectObjectContent over an erasure-coded
  object, the SQL engine, and the CSV scan lane on the card
- ``minio_tpu_torch.runtime``  the batching dispatch queue (bulk and
  interactive lanes, completers, pinned staging), buffer
  pools and the counted waits on it
- ``minio_tpu_torch.native``   the host engines: ``libnative.so`` built by
  g++ at first use (HighwayHash-256, MUR3X256, GF(256), the fused block
  calls), plus numpy HighwayHash-256 and MUR3X256 as the tests' references
- ``minio_tpu_torch.storage``  the disk backend: volumes, shard files, the
  xl.meta version journal and its fsync policy
- ``minio_tpu_torch.objectlayer`` PUT/GET/delete/list/heal/multipart over
  one erasure set (``ErasureObjects``), sets (``ErasureSets``) and pools
  (``ServerPools``), with the listing cache
- ``minio_tpu_torch.utils``    errors, device resolution, the MessagePack
  subset the journals use, the ETag readers, SipHash set placement

Entry points run on the CUDA card unless the caller passes ``device="cpu"``;
on a CPU tensor every kernel wrapper takes its plain PyTorch version. The
package imports ``torch`` and numpy, never ``jax``, and nothing of
``minio_tpu``.
"""

__version__ = "0.1.0"
