"""Launchers of the LM stack: input specs for the dry-run cells and the
serving driver (`python -m repro_torch.launch.serve`).  Port of
`repro.launch`'s serving half; the training launcher, the mesh and the
dry run come with later slices (ROADMAP queue 1)."""
from . import specs

__all__ = ["specs"]
