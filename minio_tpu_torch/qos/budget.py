"""Per-class latency budgets, the port of the budget half of
minio_tpu/qos/budget.py. The span plane's tail sampling keeps a request's
trace when its wall breaches its class's budget.

Environment knobs (env over default: the config plane is not ported):

* ``MINIO_TPU_QOS_INTERACTIVE_BUDGET_MS`` (default 100) — latency budget
  for interactive requests (S3 object traffic).
* ``MINIO_TPU_QOS_BACKGROUND_BUDGET_MS`` (default 5000) — budget for
  background work (heals) and every other class.

Left out: ``CostModel``, the link profile's per-route estimates that feed
the JAX package's spill-to-CPU scheduler (not ported).
"""
from __future__ import annotations

import os

from . import CLASS_BACKGROUND, CLASS_INTERACTIVE

_DEFAULT_BUDGET_MS = {CLASS_INTERACTIVE: 100.0, CLASS_BACKGROUND: 5000.0}
_BUDGET_ENV = {
    CLASS_INTERACTIVE: "MINIO_TPU_QOS_INTERACTIVE_BUDGET_MS",
    CLASS_BACKGROUND: "MINIO_TPU_QOS_BACKGROUND_BUDGET_MS",
}


def _config_float(env: str, default: float) -> float:
    """The float value of ``env``, or ``default`` when unset, empty or
    not a number. Read fresh on every call (cheap; tests flip them)."""
    v = os.environ.get(env)
    try:
        return float(v) if v not in (None, "") else default
    except ValueError:
        return default


def budget_s(cls: str) -> float:
    """Latency budget (seconds) for a QoS class."""
    default = _DEFAULT_BUDGET_MS.get(cls,
                                     _DEFAULT_BUDGET_MS[CLASS_BACKGROUND])
    env = _BUDGET_ENV.get(cls, _BUDGET_ENV[CLASS_BACKGROUND])
    return _config_float(env, default) / 1e3
