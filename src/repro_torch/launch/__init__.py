"""Launchers of the port: the serving loop
(``python -m repro_torch.launch.serve``) and the training driver
(``python -m repro_torch.launch.train``)."""
