"""dmlc_tpu_torch.parallel: the mesh over ``torch.distributed``
(``mesh.py``), its named collectives and ``initialize_distributed``
(``collectives.py``), the SPMD pipeline (``pipeline.py``), ring
attention (``ring_attention.py``), Ulysses (``ulysses.py``), and both
halves of the JAX package's ``parallel/overlap.py`` (``DeviceBucketer``:
a mesh step's (dp, sp) gradient reduction in buckets issued during the
backward; ``GradientBucketer``: bucketed gradient allreduce on a
background collective thread, CUDA leaves staged through pinned host
buckets).

The package exports the mesh and the collectives only, so that
``ops.core`` can use them without importing the attention modules,
which build on ``ops.flash_attention``: import the pipeline, ring
attention and Ulysses from their modules."""

from .collectives import (  # noqa: F401
    all_gather,
    all_reduce,
    all_to_all,
    axis_rank,
    axis_size,
    barrier_sum,
    broadcast,
    broadcast_object,
    copy_to,
    initialize_distributed,
    mean_from,
    ppermute_pair,
    ppermute_ring,
    process_rank_world,
    reduce_from,
    reduce_scatter,
)
from .mesh import (  # noqa: F401
    MESH_AXES,
    Mesh,
    MeshConfig,
    build_mesh,
    factorize_devices,
    mesh_config,
)
