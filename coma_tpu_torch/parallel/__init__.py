"""Work over several ranks through ``torch.distributed`` (counterpart of
``coma_tpu.parallel``): multi-process extraction (``distributed.py``),
``--mesh`` inpainting (``flagship.py``) and the (data, model) grid of the
ComA aggregation (``sharding.py``)."""
from coma_tpu_torch.parallel.flagship import rank_batches, resolve_mesh
from coma_tpu_torch.parallel.sharding import (
    Grid2D,
    gather_over_h,
    grid_2d,
    pad_batch,
    round_up,
    shard_state_over_h,
    sharded_contact_aggregate_2d,
)

__all__ = [
    "Grid2D",
    "gather_over_h",
    "grid_2d",
    "pad_batch",
    "rank_batches",
    "resolve_mesh",
    "round_up",
    "shard_state_over_h",
    "sharded_contact_aggregate_2d",
]
