from .reference import solve_csr_seq, solve_transformed_seq, solve_dense
from .schedule import (LevelSchedule, WidthGroup, build_schedule,
                       schedule_for_csr, schedule_for_preamble,
                       schedule_for_transformed)
from .levelset import (DeviceSchedule, resolve_device, schedule_from_numpy,
                       solve_levels, to_device)
from .engines import (CudaEngine, Engine, TorchEngine, get_engine,
                      register_engine, registered_engines, resolve_engine)
from .operator import (OperatorStats, TriangularOperator, compose_sweep_fn,
                       orient_lower)
