"""Per-class latency budgets, the port of the budget half of
minio_tpu/qos/budget.py. The span plane's tail sampling keeps a request's
trace when its wall breaches its class's budget, and the SLO plane seeds
its latency thresholds from the same budgets.

Knobs (config subsystem ``qos``, env > stored > default):

* ``MINIO_TPU_QOS_INTERACTIVE_BUDGET_MS`` (default 100) — latency budget
  for interactive requests (S3 object traffic).
* ``MINIO_TPU_QOS_BACKGROUND_BUDGET_MS`` (default 5000) — budget for
  background work (heals) and every other class.

``_config_float`` is the registry read of every float knob of the port
(qos, dispatch, profiler, slo, device_obs): the environment fresh on each
call, the stored value through a short-TTL cache.

Left out: ``CostModel``, the link profile's per-route estimates that feed
the JAX package's spill-to-CPU scheduler (not ported).
"""
from __future__ import annotations

import os
import time

from . import CLASS_BACKGROUND, CLASS_INTERACTIVE

_DEFAULT_BUDGET_MS = {CLASS_INTERACTIVE: 100.0, CLASS_BACKGROUND: 5000.0}
_BUDGET_ENV = {
    CLASS_INTERACTIVE: "MINIO_TPU_QOS_INTERACTIVE_BUDGET_MS",
    CLASS_BACKGROUND: "MINIO_TPU_QOS_BACKGROUND_BUDGET_MS",
}
_BUDGET_KEY = {
    CLASS_INTERACTIVE: "interactive_budget_ms",
    CLASS_BACKGROUND: "background_budget_ms",
}

#: stored-config lookups cached briefly: budget_s runs in every request's
#: finish and every dispatch item's accounting, and taking the
#: process-global ConfigSys lock per call would serialize them for a value
#: that only changes on operator action. Env vars are read fresh (cheap,
#: and tests flip them); only the registry layer is cached. Planes whose
#: set-config-kv must apply at once drop their entries in an on_apply hook.
_CFG_TTL_S = 5.0
_cfg_cache: dict[tuple[str, str], tuple[str | None, float]] = {}


def _config_float(subsys: str, key: str, env: str, default: float) -> float:
    """env > stored > default for ``subsys.key``, as a float; ``default``
    when the value is empty or not a number."""
    v = os.environ.get(env)
    if v is None:
        hit = _cfg_cache.get((subsys, key))
        now = time.monotonic()
        if hit is not None and now < hit[1]:
            v = hit[0]
        else:
            from ..config import get_config_sys
            try:
                v = get_config_sys().get(subsys, key)
            except KeyError:  # not a registry key: the default
                v = None
            _cfg_cache[(subsys, key)] = (v, now + _CFG_TTL_S)
    try:
        return float(v) if v not in (None, "") else default
    except ValueError:
        return default


def budget_s(cls: str) -> float:
    """Latency budget (seconds) for a QoS class."""
    if cls not in _BUDGET_KEY:
        cls = CLASS_BACKGROUND
    return _config_float("qos", _BUDGET_KEY[cls], _BUDGET_ENV[cls],
                         _DEFAULT_BUDGET_MS[cls]) / 1e3
