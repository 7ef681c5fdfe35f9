"""repro_torch.optim — AdamW with the reference's memory options, and
int8 gradient all-reduce with error feedback.

adamw     AdamWConfig, adamw_init, global_norm, adamw_update
compress  compress_psum over a gloo group or a DataMesh
"""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.compress import compress_psum  # noqa: F401
