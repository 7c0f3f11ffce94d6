"""Serving: one frozen decode core (DecodeCore), whose steps run as CUDA
graphs on the card, under two request layers — the fixed-batch
ServeSession and the slot-scheduled, paged-KV ContinuousBatchingEngine —
all planner-gated, and the prefill forward (`make_prefill`)."""
from .core import DecodeCore, sample_token
from .engine import (CIM_ROUTE, ServeSession, cim_fraction, make_prefill,
                     make_serve_step)
from .scheduler import (BlockAllocator, ContinuousBatchingEngine, Request,
                        poisson_arrivals, synthetic_requests)

__all__ = ["ServeSession", "DecodeCore", "ContinuousBatchingEngine",
           "Request", "BlockAllocator", "make_prefill", "make_serve_step",
           "cim_fraction", "sample_token",
           "synthetic_requests", "poisson_arrivals", "CIM_ROUTE"]
