"""Serving: one frozen decode core (DecodeCore) under the fixed-batch
ServeSession, planner-gated, and the prefill forward (`make_prefill`)."""
from .core import DecodeCore, sample_token
from .engine import (CIM_ROUTE, ServeSession, cim_fraction, make_prefill,
                     make_serve_step)

__all__ = ["ServeSession", "DecodeCore", "make_prefill", "make_serve_step",
           "cim_fraction", "sample_token", "CIM_ROUTE"]
