"""Launchers of the LM stack: input specs for the dry-run cells, the
serving launcher (`python -m repro_torch.launch.serve`) and the training
launcher (`python -m repro_torch.launch.train`).  Port of `repro.launch`
on one device; the mesh and the dry run come with later slices (ROADMAP
queue 1)."""
from . import specs

__all__ = ["specs"]
