"""Tensor ops of the port: plain PyTorch ops (``core``) and the two
attention ops whose CUDA kernels replace the TPU's Pallas kernels
(``flash_attention``, ``paged_attention``).  Kernels build at first use
(``_build``), never at import."""
