"""Serving (PyTorch twin of ``repro.serve``, its local half so far): the
plan-cached ``QueryService`` and the LM's batched ``ServeEngine``. The
serving runtime and its fault schedule are ROADMAP.md queue 1 item 7."""

from .engine import Request, ServeEngine  # noqa: F401
from .query_service import QueryService, lift_program  # noqa: F401
