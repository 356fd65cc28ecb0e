"""The paper's contribution: elastic partition placement for BSP graph jobs
(the ported modules of ``repro.core``).

  timing      -- the time function A : P_i x s -> tau_i^s (trace- or model-derived)
  metagraph   -- coarse sketch + a-priori activation/time prediction
  placement   -- Default / OPT / FFD / MF-P / LA-P placement strategies
  activation  -- VM keep-vs-terminate policy across idle gaps
  billing     -- makespan / core-min cost / core-secs / under-utilization
  replan      -- online re-planning: activity-decay extrapolation + splice
  repartition -- bounded LPA repartitioning after graph mutations
  elastic     -- the windowed executor mapping placement schedules onto
                 torch devices (``core.elastic.ElasticBSPExecutor``)
"""

from repro_torch.core.billing import BillingModel, CostReport, evaluate
from repro_torch.core.metagraph import Metagraph, build_metagraph, predict_time_function
from repro_torch.core.placement import (
    STRATEGIES,
    Placement,
    default_placement,
    ffd_placement,
    lap_placement,
    mfp_placement,
    opt_placement,
)
from repro_torch.core.replan import OnlineReplanner, ReplanConfig, extrapolate_tau
from repro_torch.core.timing import TimeFunction

__all__ = [
    "OnlineReplanner",
    "ReplanConfig",
    "extrapolate_tau",
    "TimeFunction",
    "Metagraph",
    "build_metagraph",
    "predict_time_function",
    "Placement",
    "default_placement",
    "ffd_placement",
    "opt_placement",
    "mfp_placement",
    "lap_placement",
    "STRATEGIES",
    "BillingModel",
    "CostReport",
    "evaluate",
]
