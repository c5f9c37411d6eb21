"""Serving (PyTorch twin of ``repro.serve``): the plan-cached
``QueryService``, the fault-tolerant ``ServingRuntime`` over it with its
chaos schedule, and the LM's batched ``ServeEngine``."""

from .engine import Request, ServeEngine  # noqa: F401
from .query_service import QueryService, lift_program  # noqa: F401
from .runtime import (PlanCacheManifest, QueryRequest,  # noqa: F401
                      QueryResponse, ServingRuntime)
from .faults import FAULTS, arm_chaos_schedule  # noqa: F401
