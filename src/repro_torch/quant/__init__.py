"""INT8 weight quantization, the low-bit (INT4, FP8) formats, the
planner-gated linear routes, and the static KernelPlanTable carrying
What/When/Where verdicts into the model stack."""
from .int8 import (PROJECTION_WEIGHT_NAMES, dequant_contract,
                   dequantize_weight, planned_linear, quantization_error,
                   quantize_model_params, quantize_tree, quantize_weight)
from .lowbit import (FP8_DTYPE, FP8_MAX, PRECISIONS, dequant_contract_fp8,
                     dequant_contract_int4, dequantize_weight_fp8,
                     dequantize_weight_int4, pack_int4, planned_linear_fp8,
                     planned_linear_int4, quantize_model_params_lowbit,
                     quantize_weight_fp8, quantize_weight_int4, unpack_int4,
                     weight_format)
from .plan_table import KernelPlanTable, PlanEntry, strip_model_prefix

__all__ = ["quantize_weight", "dequantize_weight", "dequant_contract",
           "quantize_tree", "quantization_error",
           "quantize_model_params", "planned_linear",
           "PROJECTION_WEIGHT_NAMES", "KernelPlanTable", "PlanEntry",
           "strip_model_prefix", "FP8_DTYPE", "FP8_MAX", "PRECISIONS",
           "quantize_weight_int4", "pack_int4", "unpack_int4",
           "dequantize_weight_int4", "quantize_weight_fp8",
           "dequantize_weight_fp8", "dequant_contract_int4",
           "dequant_contract_fp8", "planned_linear_int4",
           "planned_linear_fp8", "weight_format",
           "quantize_model_params_lowbit"]
