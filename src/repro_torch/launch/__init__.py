"""Launchers of the port: training (``python -m repro_torch.launch.train``,
one process per card under ``torchrun``), serving (``python -m
repro_torch.launch.serve``), the scenario campaign (``python -m
repro_torch.launch.campaign``), the fleet-composition search (``python -m
repro_torch.launch.compose``), the dry run (``python -m
repro_torch.launch.dryrun``: every arch × shape × mesh cell reckoned on
fake tensors, no card needed) and the meshes of the training path
(``launch.mesh``)."""

from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

__all__ = ["make_host_mesh", "make_production_mesh", "reckon", "run_cell", "serving_rows"]


def __getattr__(name):
    # the dry run's names, imported on first use: importing the package must not
    # load ``launch.dryrun`` before ``python -m repro_torch.launch.dryrun`` runs it
    if name in ("reckon", "run_cell", "serving_rows"):
        from repro_torch.launch import dryrun
        return getattr(dryrun, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
