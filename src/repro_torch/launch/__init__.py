"""Launchers of the port: the serving loop
(``python -m repro_torch.launch.serve``)."""
