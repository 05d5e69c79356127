"""Data ETL: Ohashi OGTT cohort, Fujita external cohort."""

from conditional_ude_tpu.data.fujita import (
    FujitaCohort,
    load_fujita,
    load_fujita_npz,
)
from conditional_ude_tpu.data.ohashi import (
    OhashiSplit,
    load_npz,
    load_ohashi,
    save_npz,
)

__all__ = [
    "FujitaCohort",
    "OhashiSplit",
    "load_fujita",
    "load_fujita_npz",
    "load_npz",
    "load_ohashi",
    "save_npz",
]
