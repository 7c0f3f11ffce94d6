"""INT8 weight quantization, the planner-gated linear route, and the
static KernelPlanTable carrying What/When/Where verdicts into the model
stack."""
from .int8 import (PROJECTION_WEIGHT_NAMES, dequant_contract,
                   dequantize_weight, planned_linear, quantize_model_params,
                   quantize_weight)
from .plan_table import KernelPlanTable, PlanEntry, strip_model_prefix

__all__ = ["quantize_weight", "dequantize_weight", "dequant_contract",
           "quantize_model_params", "planned_linear",
           "PROJECTION_WEIGHT_NAMES", "KernelPlanTable", "PlanEntry",
           "strip_model_prefix"]
