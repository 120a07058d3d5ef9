"""Launchers of the port: GED and LM serving
(``python -m repro_torch.launch.serve --mode ged|lm``) and LM training
(``python -m repro_torch.launch.train``)."""
