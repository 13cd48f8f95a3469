"""Launchers of the port: training (``python -m repro_torch.launch.train``,
one process per card under ``torchrun``), serving (``python -m
repro_torch.launch.serve``), the scenario campaign (``python -m
repro_torch.launch.campaign``), the fleet-composition search (``python -m
repro_torch.launch.compose``) and the meshes of the training path
(``launch.mesh``)."""

from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

__all__ = ["make_host_mesh", "make_production_mesh"]
