"""repro_torch.launch — the serving and training launchers (``python -m
repro_torch.launch.serve``, ``python -m repro_torch.launch.train``) and the
train step (``steps``)."""
