from repro_torch.sharding.specs import (OP_CLASS_AXES, NamedSharding,
                                        batch_sharding, clamp_degree_for_axis,
                                        degree_to_axes, distribute_tree,
                                        named_sharding_tree, place_cache,
                                        placements_for, plan_from_degrees, replicated,
                                        validate_plan)
from repro_torch.sharding.collective_matmul import (ring_ag_matmul,
                                                    reference_ag_matmul)

__all__ = ["OP_CLASS_AXES", "NamedSharding", "named_sharding_tree",
           "placements_for", "batch_sharding", "replicated",
           "distribute_tree", "place_cache", "plan_from_degrees", "degree_to_axes",
           "clamp_degree_for_axis", "validate_plan", "ring_ag_matmul",
           "reference_ag_matmul"]
