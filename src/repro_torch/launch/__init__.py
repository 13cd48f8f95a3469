"""Launchers of the port: serving (``python -m repro_torch.launch.serve``)
and the scenario campaign (``python -m repro_torch.launch.campaign``)."""
