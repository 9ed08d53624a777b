"""Runtime checks of the port (``paddle_tpu/analysis``).

Only :mod:`.sanitizer`'s host-ledger growth sentinel is ported: the serving
fleets call it from their tick loops under ``FLAGS_sanitize``. The
reference's static passes (program IR, AST lint, SPMD/HLO, dispatch hygiene)
and the sanitizer's JAX-specific guards (transfer guard, recompile churn,
donated-state poisoning) are not (ROADMAP.md, Queue 1 item 15).
"""
from . import sanitizer  # noqa: F401

__all__ = ["sanitizer"]
