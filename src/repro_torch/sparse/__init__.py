from .csr import CSR, from_coo, identity, tril
from .levels import LevelSets, build_levels, level_costs, row_costs
from . import generators
