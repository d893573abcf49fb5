"""repro_torch.launch — the serving and training launchers (``python -m
repro_torch.launch.serve``, ``python -m repro_torch.launch.train``), the
train, prefill and decode steps with their shardings (``steps``), the meshes
(``mesh``) and the GPipe forward (``pipeline``)."""
