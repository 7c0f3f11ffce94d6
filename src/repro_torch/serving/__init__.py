"""Serving: one frozen decode core (DecodeCore) under the fixed-batch
ServeSession, planner-gated."""
from .core import DecodeCore, sample_token
from .engine import CIM_ROUTE, ServeSession, cim_fraction, make_serve_step

__all__ = ["ServeSession", "DecodeCore", "make_serve_step", "cim_fraction",
           "sample_token", "CIM_ROUTE"]
