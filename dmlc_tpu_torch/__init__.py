"""dmlc_tpu_torch: the PyTorch / CUDA port of ``dmlc_tpu`` for an NVIDIA H100.

The JAX package ``dmlc_tpu`` stays the reference; this package keeps its
layout (``io/``, ``data/``, ``feed/``, ``checkpoint/``, ``ops/``,
``models/``, ``serving/``, ``telemetry/``) so each module's counterpart is easy to
find, imports ``torch`` and never ``jax``, and imports nothing of
``dmlc_tpu``.  Every kernel the JAX package wrote in Pallas for the
TPU is a hand-written CUDA kernel here (``ops/csrc/``), built with
``nvcc`` at first use; each sits beside a plain PyTorch version that a
CPU tensor is routed to.

Ported so far, on one card: the serving path (flagship-model prefill
through the flash-attention forward kernel and paged decode through the
paged-attention kernel, behind a continuous-batching engine and an HTTP
server, ``python -m dmlc_tpu_torch.serving.serve``), the training
path (``models.transformer.make_train_step``: the flagship loss with
per-block remat, flash attention's backward kernels, AdamW), and the
data spine that feeds it: RecordIO shards through the byte-range input
split (``io``) and the device feed (``feed``) into the train step, with
checkpoints in the JAX package's format (``checkpoint``;
``python -m dmlc_tpu_torch.examples.train_lm_recordio``); and the
telemetry those paths drive (``telemetry``: the step ledger on the
train and decode steps, the request, SLO and availability ledgers, the
Prometheus and Chrome-trace exporters behind the server's endpoints,
and ``serving.loadgen``), with the JAX package's metric names; and
dmlc-core's sparse text path: the LibSVM, CSV and libfm parsers
(``data``) over the input splits (text, RecordIO, indexed, stdin,
``#cachefile``) into ``feed.libsvm_feed``, on a host C++ core
(``native``) shared with the RecordIO feed's scan and packs; and
dmlc-core's communication bootstrap: the rank-rendezvous tracker and the
job launcher (``tracker``; ``python -m dmlc_tpu_torch.tracker.submit``),
the host collectives (tree, chunked ring, and hierarchical over the C++
shm group of ``native/csrc/dmlc_collective.cc``), the gradient bucketer
(``parallel.overlap``), retry and fault injection (``resilience``), and
the distributed LibSVM/CSV examples training on the card.
"""

__version__ = "0.1.0"
