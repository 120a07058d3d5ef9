"""Launchers of the port: the GED serving entry point
(``python -m repro_torch.launch.serve --mode ged``)."""
