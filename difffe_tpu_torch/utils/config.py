"""Scenario configuration: dataclass configs for the five BASELINE configs.

The port's own copy of ``difffe_tpu/utils/config.py`` (the same fields,
defaults and configs).  The kwargs-style Python API stays primary; these
configs parameterize the command line (cli.py).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """One benchmark scenario (see BASELINE.json 'configs')."""

    name: str
    dim: int = 1
    n_elements: int = 20              # per axis for 2D
    batch: int = 1
    method: str = "auto"
    dtype: str = "f32"                # 'f32' | 'f64' (golden path)
    horizon: int = 0                  # >0 → time-dependent rollout
    dt: float = 1e-3
    n_opt_steps: int = 200
    lr: float = 0.1
    seed: int = 0
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ScenarioConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in d.items() if k in fields}
        extra = {k: v for k, v in d.items() if k not in fields}
        if extra:
            known.setdefault("extra", {}).update(extra)
        return cls(**known)


# The five north-star configs (BASELINE.json "configs", same order).
BASELINE_CONFIGS = {
    "demo_1d": ScenarioConfig(
        name="demo_1d", dim=1, n_elements=20, batch=1,
        dtype="f64", n_opt_steps=200),
    "batched_inverse_1d": ScenarioConfig(
        name="batched_inverse_1d", dim=1, n_elements=128, batch=1024,
        n_opt_steps=200),
    "heat_mpc_1d": ScenarioConfig(
        name="heat_mpc_1d", dim=1, n_elements=64, batch=4096,
        horizon=50, dt=2e-3, n_opt_steps=60),
    "kappa_field_2d": ScenarioConfig(
        name="kappa_field_2d", dim=2, n_elements=64, batch=64,
        method="cg", n_opt_steps=100),
    "topopt_2d": ScenarioConfig(
        name="topopt_2d", dim=2, n_elements=32, batch=16,
        n_opt_steps=50),
}
