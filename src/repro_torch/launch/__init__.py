"""Launchers of the LM stack: input specs for the dry-run cells, the
production and local meshes (`mesh`), the serving launcher (`python -m
repro_torch.launch.serve`) and the training launcher (`python -m
repro_torch.launch.train`, on one device or on N ranks).  Port of
`repro.launch`; the dry run comes with a later slice (ROADMAP queue 1)."""
from . import mesh, specs

__all__ = ["mesh", "specs"]
