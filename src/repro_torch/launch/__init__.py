"""repro_torch.launch — command-line entry points (``python -m
repro_torch.launch.train``, ``python -m repro_torch.launch.serve``) and
the meshes they run on (``launch.mesh``)."""
