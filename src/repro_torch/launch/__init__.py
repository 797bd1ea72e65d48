"""Entry points of the port: the serving mesh (``mesh``) and the serve
launcher (``python -m repro_torch.launch.serve``)."""
