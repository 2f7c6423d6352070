"""Data parallelism over ``torch.distributed`` (the ``data`` axis of the
JAX package's ``parallel/mesh.py``) and the multi-process dry run."""

from fast_cwdm_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    SPATIAL_AXIS,
    TENSOR_AXIS,
    DataMesh,
    local_batch_rows,
    local_batch_size,
    make_hybrid_mesh,
    make_mesh,
    setup_distributed,
    shard_batch,
)
