"""dmlc_tpu_torch: the PyTorch / CUDA port of ``dmlc_tpu`` for an NVIDIA H100.

The JAX package ``dmlc_tpu`` stays the reference; this package keeps its
layout (``ops/``, ``models/``, ``serving/``) so each module's counterpart
is easy to find, imports ``torch`` and never ``jax``, and imports nothing
of ``dmlc_tpu``.  Every kernel the JAX package wrote in Pallas for the
TPU is a hand-written CUDA kernel here (``ops/csrc/``), built with
``nvcc`` at first use; each sits beside a plain PyTorch version that a
CPU tensor is routed to.

Ported so far, on one card: the serving path (flagship-model prefill
through the flash-attention forward kernel and paged decode through the
paged-attention kernel, behind a continuous-batching engine and an HTTP
server, ``python -m dmlc_tpu_torch.serving.serve``) and the training
path (``models.transformer.make_train_step``: the flagship loss with
per-block remat, flash attention's backward kernels, AdamW).
"""
