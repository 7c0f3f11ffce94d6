"""The WWW cost model, the What/When/Where planner and the campaigns.

The scalar cost-model modules are copies of the JAX package's (they hold
no JAX), and so are `heuristic` (the random-search mapper of the paper's
Fig. 7 / Table II) and `workloads` (Table VI's real workloads and the
synthetic and square GEMM sets).  `vectorized` is the batched cost
model on torch tensors, `sweep` the batched engine behind the planner's
"vectorized" and "pallas" backends (the latter on the hand-written sweep
kernel), and `pareto` / `campaign` the design-space campaigns on that
engine, and `plan_service` the shape-bucketed plan service the
continuous-batching engine consults under live traffic.
"""
from .baseline import evaluate_baseline
from .campaign import (FRONT_FIELDS, CampaignResult, CampaignSpec,
                       Constraint, build_config, certify_front,
                       certify_point, parse_precision, run_campaign)
from .cost_model import Metrics, evaluate, evaluate_cim
from .gemm import GEMM, attention_gemms, conv2d_gemm, fc_gemm
from .heuristic import random_search
from .llm_workloads import (gemms_of_model, is_projection_label,
                            phase_gemms_of_model)
from .mapping import CiMMapping, priority_map
from .pareto import (ParetoAccumulator, dominates, pareto_mask,
                     pareto_mask_np, pareto_mask_ref)
from .memory import (DRAM, LEVELS, RF, SMEM, CiMSystemConfig, configb_count,
                     iso_area_primitive_count)
from .plan_service import BucketLattice, PlanService
from .planner import (Decision, decide, make_decision, plan_workload,
                      plan_workload_by_phase, standard_configs, summarize)
from .sweep import (CIM_BACKENDS, SweepEngine, decide_batched,
                    default_engine, measured_cache_delta,
                    plan_workload_batched, sweep_evaluate,
                    sweep_evaluate_baseline)
from .primitives import (ANALOG_6T, ANALOG_8T, DIGITAL_6T, DIGITAL_8T,
                         PRIMITIVES, SUPPORTED_BITS, TENSOR_CORE,
                         CiMPrimitive, TensorCoreSpec,
                         mac_energy_pj_from_tops_w, precision_factors,
                         tech_scale_ratio)
from .vectorized import (FLAT_FIELDS, evaluate_baseline_flat, evaluate_batch,
                         evaluate_flat, exhaustive_best)
from .workloads import (BERT_LARGE, DLRM, GPT_J, REAL_WORKLOADS, RESNET50,
                        square_sweep, synthetic_dataset)

__all__ = [
    "GEMM", "CiMPrimitive", "CiMSystemConfig", "CiMMapping", "Metrics",
    "priority_map", "evaluate", "evaluate_cim", "evaluate_baseline",
    "decide", "plan_workload", "standard_configs", "summarize", "Decision",
    "plan_workload_by_phase", "make_decision",
    "BucketLattice", "PlanService",
    "ANALOG_6T", "ANALOG_8T", "DIGITAL_6T", "DIGITAL_8T", "PRIMITIVES",
    "TENSOR_CORE", "TensorCoreSpec", "DRAM", "SMEM", "RF", "LEVELS",
    "iso_area_primitive_count", "configb_count", "SUPPORTED_BITS",
    "mac_energy_pj_from_tops_w", "precision_factors", "tech_scale_ratio",
    "attention_gemms", "conv2d_gemm", "fc_gemm",
    "gemms_of_model", "phase_gemms_of_model", "is_projection_label",
    "FLAT_FIELDS", "evaluate_flat", "evaluate_batch",
    "evaluate_baseline_flat", "exhaustive_best",
    "CIM_BACKENDS", "SweepEngine", "default_engine", "measured_cache_delta",
    "decide_batched", "plan_workload_batched", "sweep_evaluate",
    "sweep_evaluate_baseline",
    "ParetoAccumulator", "dominates", "pareto_mask", "pareto_mask_np",
    "pareto_mask_ref",
    "FRONT_FIELDS", "CampaignSpec", "CampaignResult", "Constraint",
    "build_config", "run_campaign", "certify_point", "certify_front",
    "parse_precision",
    "random_search", "BERT_LARGE", "GPT_J", "DLRM", "RESNET50",
    "REAL_WORKLOADS", "synthetic_dataset", "square_sweep",
]
