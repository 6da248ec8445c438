"""Launchers of the LM stack: input specs for the dry-run cells, the
production and local meshes (`mesh`), the serving launcher (`python -m
repro_torch.launch.serve`), the training launcher (`python -m
repro_torch.launch.train`, on one device or on N ranks) and the dry run
(`python -m repro_torch.launch.dryrun`, every cell counted on a fake
mesh over meta tensors by `op_analysis`).  Port of `repro.launch`."""
from . import mesh, specs

__all__ = ["mesh", "specs"]
