"""Fujita external-validation cohort ETL.

Port of section 2 of ``c-peptide/00-prepare-data.jl:170-187``: 20 subjects,
14 OGTT timepoints (−10 … 240 min), ages fixed at 29, same unit conversions
as the Ohashi pipeline.  Used by the symbolic-model external validation
(``c-peptide/04-symreg-external.jl``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from conditional_ude_tpu.data.ohashi import GLUCOSE_TO_MMOL_L, CPEPTIDE_TO_NMOL_L

FUJITA_AGE = 29.0


@dataclasses.dataclass
class FujitaCohort:
    glucose: np.ndarray     # [N, 14] mmol/L
    cpeptide: np.ndarray    # [N, 14] nmol/L
    timepoints: np.ndarray  # [14]
    ages: np.ndarray        # [N], all 29

    @property
    def t2dm(self) -> np.ndarray:
        # non-diabetic cohort (04-symreg-external.jl:44-46)
        return np.zeros(len(self.ages), dtype=bool)


def load_fujita(csv_dir: str | Path) -> FujitaCohort:
    import pandas as pd

    df = pd.read_csv(Path(csv_dir) / "fujita_ogtt.csv")
    time_cols = df.columns[2:-1]
    timepoints = np.array([float(c) for c in time_cols])
    glucose = df.loc[df["Molecule"] == "Glucose", time_cols].to_numpy(
        dtype=float) * GLUCOSE_TO_MMOL_L
    cpeptide = df.loc[df["Molecule"] == "C-peptide", time_cols].to_numpy(
        dtype=float) * CPEPTIDE_TO_NMOL_L
    ages = np.full(glucose.shape[0], FUJITA_AGE)
    return FujitaCohort(glucose=glucose, cpeptide=cpeptide,
                        timepoints=timepoints, ages=ages)


def load_fujita_npz(path: str | Path) -> FujitaCohort:
    """Read the cohort back from the ``.npz`` the ETL writes."""
    data = np.load(path, allow_pickle=False)
    return FujitaCohort(**{f.name: data[f.name]
                           for f in dataclasses.fields(FujitaCohort)})
