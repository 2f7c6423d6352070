"""Data, spatial and tensor parallelism over ``torch.distributed`` (the
``data``, ``sp`` and ``tp`` axes of the JAX package's ``parallel/mesh.py``)
and the multi-process dry run."""

from fast_cwdm_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    SPATIAL_AXIS,
    TENSOR_AXIS,
    DataMesh,
    SpAxis,
    TpAxis,
    all_gather_sp,
    all_reduce_sum_sp,
    current_sp,
    current_tp,
    gather_params,
    global_sum_sp,
    halo_exchange,
    local_batch_rows,
    local_batch_size,
    local_slab,
    make_hybrid_mesh,
    make_mesh,
    param_spec,
    setup_distributed,
    shard_batch,
    shard_params,
    shard_tensors,
    sp_active,
    tp_active,
)
