"""The ComA affordance math in PyTorch (counterpart of ``coma_tpu.affordance``).

Reference parity: ``utils/coma.py`` and ``utils/coma_occupancy.py``.
"""
from coma_tpu_torch.affordance.canonicalize import canonicalize_pairwise
from coma_tpu_torch.affordance.contact import (
    aggregate_contact,
    contact_map,
    contact_update,
    contact_update_batch,
    merge_states,
    nonphysical_response,
    orientational_tendency,
    significant_contact_pairs,
)
from coma_tpu_torch.affordance.evaluation import mean_absolute_error, quant_metrics, similarity
from coma_tpu_torch.affordance.io import (
    load_coma_state,
    load_occupancy_state,
    save_coma_state,
    save_occupancy_state,
)
from coma_tpu_torch.affordance.occupancy import (
    aggregated_occupancy,
    merge_occupancy_states,
    occupancy_product,
    occupancy_update,
    occupancy_update_batch,
)
from coma_tpu_torch.affordance.sphere import fibonacci_sphere, geodesic_gaussian
from coma_tpu_torch.affordance.state import (
    ComAState,
    OccupancyState,
    init_coma_state,
    init_occupancy_state,
    make_voxel_grid,
)

__all__ = [
    "ComAState",
    "OccupancyState",
    "aggregate_contact",
    "aggregated_occupancy",
    "canonicalize_pairwise",
    "contact_map",
    "contact_update",
    "contact_update_batch",
    "fibonacci_sphere",
    "geodesic_gaussian",
    "init_coma_state",
    "init_occupancy_state",
    "load_coma_state",
    "load_occupancy_state",
    "make_voxel_grid",
    "mean_absolute_error",
    "merge_occupancy_states",
    "merge_states",
    "nonphysical_response",
    "occupancy_product",
    "occupancy_update",
    "occupancy_update_batch",
    "orientational_tendency",
    "quant_metrics",
    "save_coma_state",
    "save_occupancy_state",
    "significant_contact_pairs",
    "similarity",
]
