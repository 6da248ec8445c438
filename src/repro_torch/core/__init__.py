"""Host half of the transform pipeline (numpy copies of `repro.core`)."""
from .graph import CostModel, GraphView
from .rewrite import EquationStore, RewriteResult
from .strategies import (AvgLevelCost, ConstrainedAvgLevelCost,
                         CriticalPathRewrite, ManualEveryK, NoRewrite,
                         Strategy, StrategyStats, strategy_label)
from .transform import (TransformMetrics, TransformedSystem,
                        replay_transform, transform)
from .codegen import generate_c_source, generated_code_bytes
from .portfolio import (STRATEGY_REGISTRY, PairReport, PortfolioCandidate,
                        PortfolioReport, StrategyPortfolio,
                        default_candidates, default_cost_model_for,
                        make_strategy)
from .portfolio import CostModel as TuningCostModel
from .resilience import (CacheQuarantineWarning, EngineFallbackError,
                         EngineFallbackWarning, HealthPolicy,
                         HealthRepairWarning, NumericalHealthError,
                         PatternMismatchError, ResilienceError,
                         ResilienceWarning, RetryPolicy,
                         ScheduleInvariantError, SolveGuard,
                         TransformInvariantError, resolve_health_policy)
