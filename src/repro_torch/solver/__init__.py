from .reference import solve_csr_seq, solve_transformed_seq, solve_dense
from .schedule import (LevelSchedule, WidthGroup, build_schedule,
                       repack_schedule_values, schedule_for_csr,
                       schedule_for_preamble, schedule_for_transformed,
                       validate_schedule)
from .levelset import (DeviceSchedule, resolve_device, schedule_from_numpy,
                       solve_levels, to_device)
from .engines import (CudaEngine, Engine, ShardedEngine, TorchEngine,
                      engine_fallbacks, fallback_chains, get_engine,
                      register_engine, registered_engines, resolve_engine,
                      resolve_placement, set_fallback_chain, sharded_engine)
from .operator import (OperatorStats, TriangularOperator, compose_sweep_fn,
                       default_cache_dir, orient_lower)
from .api import sptrsv, with_unit_diagonal
