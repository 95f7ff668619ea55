"""Core library: the paper's runtime concurrency control + op scheduling.

The port's copy of ``repro.core`` (the reference's modules, with the
same behaviour; the executor runs its payloads on CUDA streams):
  graph        -- dataflow op-graph IR the runtime schedules
  perfmodel    -- hill-climbing performance model + regression baseline
  concurrency  -- Strategies 1-2 (per-op parallelism, hysteresis)
  planstore    -- closed-loop plan store: every prediction out
                  (predict/candidates/demand/critical-path), every
                  observation back in (launch/finish/revoke events;
                  EWMA re-estimation under feedback="ewma")
  strategy     -- StrategyCore: the S2-clamp/S3-admission/S4-hyper rules
  scheduler    -- single-graph adapter over StrategyCore + baselines
  interference -- co-run slowdown blacklist (SIII-D discussion)
  placement    -- quadrant-aware core placement (topology="quadrant")
  simmachine   -- deterministic KNL-like cost oracle
  runtime      -- profile->freeze->schedule driver, real-payload executor

On a mesh:
  autotune     -- shard-degree hill climbing on roofline measurements
"""

from repro_torch.core.graph import (
    CondRegion, DynamicGraphBuilder, DynamicOpGraph, GraphBuilder, Op,
    OpGraph, RegionEvent, WhileRegion, PAPER_INPUT_SIZES,
    build_early_exit_wave, build_paper_graph, build_recurrent_step_graph,
    build_transformer_step_graph, region_exit_op)
from repro_torch.core.perfmodel import (
    CurveCache, CurveModel, HillClimbProfiler, ProfileStore, RegressionSuite,
    paper_case_lists, power_of_two_cases, REGRESSORS)
from repro_torch.core.concurrency import (ConcurrencyController,
                                          ConcurrencyPlan, OpPlan)
from repro_torch.core.planstore import (
    AdaptivePlanStore, CorrectionTable, DemandIndex, FrozenPlanStore,
    MovePrice, OpObservation,
    PlanStore, TripCountEstimator, FEEDBACK_MODES, OBS_FINISH, OBS_LAUNCH,
    OBS_REVOKE, critical_path_from, make_plan_store, split_price)
from repro_torch.core.strategy import (
    PreemptionPolicy, StrategyAdapter, StrategyConfig, StrategyCore,
    free_cores, pick_admissible, remaining_horizon)
from repro_torch.core.scheduler import (
    CorunScheduler, ScheduleResult, ScheduledOp, uniform_schedule,
    manual_best_schedule)
from repro_torch.core.interference import InterferenceRecorder
from repro_torch.core.simmachine import SimMachine, Placement
from repro_torch.core.runtime import (
    ConcurrencyRuntime, RuntimeConfig, TrainingSummary, RealGraphExecutor)
from repro_torch.core.autotune import (
    RooflineMeasurement, ShardDegreeAutotuner, ShardDecision,
    ShardPlanResult, corun_groups, CorunGroup)

__all__ = [
    "Op", "OpGraph", "GraphBuilder", "build_paper_graph",
    "build_transformer_step_graph", "PAPER_INPUT_SIZES",
    "CondRegion", "DynamicGraphBuilder", "DynamicOpGraph", "RegionEvent",
    "WhileRegion", "build_early_exit_wave", "build_recurrent_step_graph",
    "region_exit_op", "TripCountEstimator",
    "CurveCache", "CurveModel", "HillClimbProfiler", "ProfileStore",
    "RegressionSuite",
    "paper_case_lists", "power_of_two_cases", "REGRESSORS",
    "ConcurrencyController", "ConcurrencyPlan", "OpPlan",
    "AdaptivePlanStore", "CorrectionTable", "DemandIndex", "FrozenPlanStore",
    "MovePrice", "OpObservation", "PlanStore", "FEEDBACK_MODES",
    "OBS_FINISH", "OBS_LAUNCH", "OBS_REVOKE",
    "critical_path_from", "make_plan_store", "split_price",
    "PreemptionPolicy", "StrategyAdapter", "StrategyConfig", "StrategyCore",
    "free_cores", "pick_admissible", "remaining_horizon",
    "CorunScheduler", "ScheduleResult", "ScheduledOp",
    "uniform_schedule",
    "manual_best_schedule", "InterferenceRecorder",
    "SimMachine", "Placement",
    "ConcurrencyRuntime", "RuntimeConfig", "TrainingSummary",
    "RealGraphExecutor",
    "RooflineMeasurement", "ShardDegreeAutotuner", "ShardDecision",
    "ShardPlanResult", "corun_groups", "CorunGroup",
]
