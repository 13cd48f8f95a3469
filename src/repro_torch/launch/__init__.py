"""Launchers of the port: training (``python -m repro_torch.launch.train``),
serving (``python -m repro_torch.launch.serve``), the scenario campaign
(``python -m repro_torch.launch.campaign``) and the fleet-composition
search (``python -m repro_torch.launch.compose``)."""
