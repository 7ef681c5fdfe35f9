"""repro_torch.dist: the mesh context and meshes over a gloo group, the
sharding rules, and placement plans (cost-driven layer replication, row
scale-out).

The counterpart of ``repro.dist``: engines on a mesh place their weights
by ``sharding.param_shardings`` (Megatron + FSDP, or a plan's
replication), split request rows over the data axis and run
tensor-parallel linears over the model axis (``serve/engine.py``,
``serve/cnn.py``)."""
from repro_torch.dist import api, placement, sharding  # noqa: F401
from repro_torch.dist.api import (DataMesh, Mesh, P,  # noqa: F401
                                  RecordingMesh, active_mesh, constrain, constrain_heads,
                                  dp_size, in_manual_mode, logical_to_mesh,
                                  manual_mode, mesh_axes_for,
                                  shard_map_compat, tp_size, use_mesh)
from repro_torch.dist.placement import (PlacementPlan,  # noqa: F401
                                        mesh_device_count,
                                        plan_for_controller, plan_placement)
from repro_torch.dist.sharding import (Local, cache_shardings,  # noqa: F401
                                       full, opt_shardings, param_shardings,
                                       shard_params)
