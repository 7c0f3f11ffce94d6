"""The scalar WWW cost model and the What/When/Where planner.

The cost-model modules are copies of the JAX package's (they hold no
JAX); the planner supports the scalar backend.  The batched backends
(`vectorized`, `sweep`) and the `sweep_eval` kernel are not ported yet.
"""
from .baseline import evaluate_baseline
from .cost_model import Metrics, evaluate, evaluate_cim
from .gemm import GEMM, attention_gemms, conv2d_gemm, fc_gemm
from .llm_workloads import (gemms_of_model, is_projection_label,
                            phase_gemms_of_model)
from .mapping import CiMMapping, priority_map
from .memory import (DRAM, LEVELS, RF, SMEM, CiMSystemConfig, configb_count,
                     iso_area_primitive_count)
from .planner import (Decision, decide, make_decision, plan_workload,
                      plan_workload_by_phase, standard_configs, summarize)
from .primitives import (ANALOG_6T, ANALOG_8T, DIGITAL_6T, DIGITAL_8T,
                         PRIMITIVES, SUPPORTED_BITS, TENSOR_CORE,
                         CiMPrimitive, TensorCoreSpec,
                         mac_energy_pj_from_tops_w, precision_factors,
                         tech_scale_ratio)

__all__ = [
    "GEMM", "CiMPrimitive", "CiMSystemConfig", "CiMMapping", "Metrics",
    "priority_map", "evaluate", "evaluate_cim", "evaluate_baseline",
    "decide", "plan_workload", "standard_configs", "summarize", "Decision",
    "plan_workload_by_phase", "make_decision",
    "ANALOG_6T", "ANALOG_8T", "DIGITAL_6T", "DIGITAL_8T", "PRIMITIVES",
    "TENSOR_CORE", "TensorCoreSpec", "DRAM", "SMEM", "RF", "LEVELS",
    "iso_area_primitive_count", "configb_count", "SUPPORTED_BITS",
    "mac_energy_pj_from_tops_w", "precision_factors", "tech_scale_ratio",
    "attention_gemms", "conv2d_gemm", "fc_gemm",
    "gemms_of_model", "phase_gemms_of_model", "is_projection_label",
]
