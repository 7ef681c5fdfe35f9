"""repro_torch.dist: the mesh context, a torch.distributed data mesh, and
placement plans (cost-driven layer replication, row scale-out).

The counterpart of ``repro.dist`` without its sharding rules: the port
replicates every weight on every rank and splits request rows across the
data axis (``serve/engine.py``, ``serve/cnn.py``)."""
from repro_torch.dist import api, placement  # noqa: F401
from repro_torch.dist.api import (DataMesh, active_mesh,  # noqa: F401
                                  dp_size, mesh_axes_for, tp_size,
                                  use_mesh)
from repro_torch.dist.placement import (PlacementPlan,  # noqa: F401
                                        mesh_device_count,
                                        plan_for_controller, plan_placement)
