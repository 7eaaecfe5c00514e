"""dmlc_tpu_torch.parallel: the host half of the JAX package's
``parallel/overlap.py`` (``GradientBucketer``: bucketed gradient
allreduce on a background collective thread, CUDA leaves staged through
pinned host buckets).

Not ported yet (ROADMAP.md Queue 1 item 8): the mesh, the device
collectives and ``initialize_distributed``, ring attention, Ulysses, the
pipeline, and ``bucketed_psum_mean``."""
