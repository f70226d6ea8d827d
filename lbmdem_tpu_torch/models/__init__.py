"""Benchmark scenario constructors (the 5 BASELINE.json configs);
counterpart of `lbmdem_tpu/models/__init__.py`."""

from lbmdem_tpu_torch.models.scenarios import (
    SCENARIOS,
    cavity,
    column_collapse,
    cylinder,
    dkt,
    make_scenario,
    poiseuille,
    porous_bed,
    schafer_turek,
    settling_column,
    single_disk_sedimentation,
)

__all__ = [
    "SCENARIOS",
    "make_scenario",
    "poiseuille",
    "cavity",
    "single_disk_sedimentation",
    "dkt",
    "settling_column",
    "column_collapse",
    "cylinder",
    "porous_bed",
    "schafer_turek",
]
