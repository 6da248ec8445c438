"""Host half of the transform pipeline (numpy copies of `repro.core`)."""
from .graph import CostModel, GraphView
from .rewrite import EquationStore, RewriteResult
from .strategies import (AvgLevelCost, ConstrainedAvgLevelCost,
                         CriticalPathRewrite, ManualEveryK, NoRewrite,
                         Strategy, StrategyStats, strategy_label)
from .transform import TransformMetrics, TransformedSystem, transform
from .portfolio import STRATEGY_REGISTRY, make_strategy
from .resilience import (HealthPolicy, NumericalHealthError,
                         PatternMismatchError, ResilienceError, SolveGuard,
                         resolve_health_policy)
