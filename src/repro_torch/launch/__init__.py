"""Launchers of the port: GED and LM serving
(``python -m repro_torch.launch.serve --mode ged|lm``), LM training
(``python -m repro_torch.launch.train``), and the launch layer of the
production meshes: input shapes (``shapes``), analytic FLOPs
(``flops``), meshes (``mesh``), placed steps (``steps``), per-device
cost counts (``step_analysis``) and the dry run
(``python -m repro_torch.launch.dryrun``)."""
