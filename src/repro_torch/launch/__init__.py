"""repro_torch.launch — the serving launcher (``python -m
repro_torch.launch.serve``)."""
