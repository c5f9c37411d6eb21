"""Serving (PyTorch twin of ``repro.serve``, its local half so far): the
plan-cached ``QueryService``. The serving runtime, its fault schedule
and the batch engine are ROADMAP.md queue 1 item 7."""

from .query_service import QueryService, lift_program  # noqa: F401
