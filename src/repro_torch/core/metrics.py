"""Performance metrics + the 3-year TCO model (paper §3.5 / §5.1)."""
from __future__ import annotations

from dataclasses import dataclass

HOURS_3YR = 3 * 365 * 24
ELECTRICITY_USD_PER_KWH = 0.153  # world-wide average, paper §5.1


@dataclass
class QueryMetrics:
    ttft_s: float
    tokens_per_s: float
    energy_per_token_j: float
    qps: float
    energy_per_query_j: float

    @property
    def avg_power_w(self) -> float:
        return self.qps * self.energy_per_query_j


def tco_3yr(capex_usd: float, qps: float, energy_per_query_j: float,
            electricity: float = ELECTRICITY_USD_PER_KWH) -> dict:
    """3-year total cost of ownership and TCO per sustained QPS."""
    avg_power_w = qps * energy_per_query_j
    kwh = avg_power_w * HOURS_3YR / 1000.0
    energy_cost = kwh * electricity
    tco = capex_usd + energy_cost
    return {
        "capex_usd": capex_usd,
        "avg_power_w": avg_power_w,
        "energy_kwh_3yr": kwh,
        "energy_cost_usd": energy_cost,
        "tco_usd": tco,
        "tco_per_qps": tco / qps if qps else float("inf"),
    }


def battery_queries(battery_wh: float, energy_per_query_j: float) -> float:
    """Inferences per charge (mobile §5.1)."""
    return battery_wh * 3600.0 / energy_per_query_j
