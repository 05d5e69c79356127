"""Ohashi OGTT cohort ETL.

Port of the data pipeline in ``c-peptide/00-prepare-data.jl``: read the
Ohashi OGTT / subject-info / clamp-index CSVs, drop incomplete records
(120 → 117 subjects), convert units (glucose ×0.0551 → mmol/L, c-peptide
×0.3311 → nmol/L), stratified 70/30 train/test split preserving
NGT/IGT/T2DM proportions, and persist as an ``.npz`` checkpoint (the
reference's JLD2 artifact, ``00-prepare-data.jl:104-136``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from conditional_ude_tpu.utils.stats import stratified_split

GLUCOSE_TO_MMOL_L = 0.0551
CPEPTIDE_TO_NMOL_L = 0.3311
TIMEPOINTS = np.array([0.0, 30.0, 60.0, 90.0, 120.0])

_SPLIT_SEED = 270523  # reference uses StableRNG(270523), 00-prepare-data.jl:3


def _keyed(df: "pd.DataFrame", subject_numbers: np.ndarray) -> "pd.DataFrame":
    """Reindex rows by subject number (raises on duplicate or missing 'No')
    so metadata cannot be paired with OGTT rows positionally."""
    df = df.set_index("No")
    if not df.index.is_unique:
        raise ValueError("duplicated 'No' values in a data CSV")
    return df.loc[subject_numbers]



@dataclasses.dataclass
class OhashiSplit:
    """One side of the train/test split (plain numpy, feeds ``build_cohort``)."""

    glucose: np.ndarray            # [N, 5] mmol/L
    cpeptide: np.ndarray           # [N, 5] nmol/L
    timepoints: np.ndarray         # [5]
    subject_numbers: np.ndarray    # [N]
    types: np.ndarray              # [N] str: NGT / IGT / T2DM
    ages: np.ndarray               # [N]
    body_weights: np.ndarray       # [N]
    bmis: np.ndarray               # [N]
    disposition_indices: np.ndarray
    first_phase: np.ndarray
    second_phase: np.ndarray
    total_insulin: np.ndarray
    insulin_sensitivity: np.ndarray

    @property
    def t2dm(self) -> np.ndarray:
        return self.types == "T2DM"

    def subset(self, idx) -> "OhashiSplit":
        idx = np.asarray(idx)
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            kw[f.name] = v if f.name == "timepoints" else v[idx]
        return OhashiSplit(**kw)


def load_ohashi(
    csv_dir: str | Path,
    f_train: float = 0.70,
    seed: int = _SPLIT_SEED,
) -> tuple[OhashiSplit, OhashiSplit]:
    """ETL the raw Ohashi CSVs into (train, test) splits."""
    csv_dir = Path(csv_dir)

    import pandas as pd

    ogtt = pd.read_csv(csv_dir / "ohashi_OGTT.csv", sep=";")
    ogtt = ogtt.dropna()
    subject_numbers = ogtt["No"].to_numpy()

    # join on the subject number, NOT row position: the current CSVs happen
    # to share sort order, but a re-exported file must not silently pair
    # subject i's OGTT with subject j's metadata (raises on missing or
    # duplicated 'No' instead)
    info = pd.read_csv(csv_dir / "ohashi_subjectinfo.csv", sep=";")
    info = _keyed(info, subject_numbers)

    types = info["type"].to_numpy(dtype=str)
    ages = info["age"].to_numpy(dtype=float)
    body_weights = info["BW"].to_numpy(dtype=float)
    bmis = info["BMI"].to_numpy(dtype=float)

    # columns 2:6 are glucose, 12:16 c-peptide (1-based; 00-prepare-data.jl:24-25)
    glucose = ogtt.iloc[:, 1:6].to_numpy(dtype=float) * GLUCOSE_TO_MMOL_L
    cpeptide = ogtt.iloc[:, 11:16].to_numpy(dtype=float) * CPEPTIDE_TO_NMOL_L

    clamp = pd.read_csv(csv_dir / "ohashi_clamp_indices.csv", sep=";")
    clamp = _keyed(clamp, subject_numbers)
    disposition = clamp["clamp PAI"].to_numpy(dtype=float)
    first_phase = clamp["incremental AUC IRI(10)"].to_numpy(dtype=float)
    second_phase = clamp["incremental AUC IRI(10-90)"].to_numpy(dtype=float)
    isi = clamp["ISI(GIR/Glu/IRI)"].to_numpy(dtype=float)
    total = first_phase + second_phase

    full = OhashiSplit(
        glucose=glucose, cpeptide=cpeptide, timepoints=TIMEPOINTS.copy(),
        subject_numbers=subject_numbers, types=types, ages=ages,
        body_weights=body_weights, bmis=bmis,
        disposition_indices=disposition, first_phase=first_phase,
        second_phase=second_phase, total_insulin=total,
        insulin_sensitivity=isi,
    )

    rng = np.random.default_rng(seed)
    train_idx, test_idx = stratified_split(rng, types, f_train)
    return full.subset(train_idx), full.subset(test_idx)


CLAMP_INSULIN_TIMEPOINTS = np.array([0.0, 5.0, 10.0, 15.0, 60.0, 75.0, 90.0])


def load_clamp_insulin(
    csv_dir: str | Path,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Clamp-test insulin curves for the illustration figure
    (``00-prepare-data.jl:138-167``): C-IRI at 0/5/10/15/60/75/90 min for
    the 117 retained subjects.

    Returns ``(timepoints[7], insulin[N, 7] mU/L, types[N])``.
    """
    csv_dir = Path(csv_dir)
    import pandas as pd

    ogtt = pd.read_csv(csv_dir / "ohashi_OGTT.csv", sep=";").dropna()
    subject_numbers = ogtt["No"].to_numpy()
    info = pd.read_csv(csv_dir / "ohashi_subjectinfo.csv", sep=";")
    info = _keyed(info, subject_numbers)
    types = info["type"].to_numpy(dtype=str)

    blood = pd.read_csv(csv_dir / "ohashi_clamp_blood.csv", sep=";",
                        decimal=",")
    blood = _keyed(blood, subject_numbers)
    cols = [f"C-IRI({int(t)})" for t in CLAMP_INSULIN_TIMEPOINTS]
    insulin = blood[cols].to_numpy(dtype=float)
    return CLAMP_INSULIN_TIMEPOINTS.copy(), insulin, types


def save_npz(path: str | Path, train: OhashiSplit, test: OhashiSplit) -> None:
    arrays = {}
    for tag, split in (("train", train), ("test", test)):
        for f in dataclasses.fields(split):
            arrays[f"{tag}_{f.name}"] = getattr(split, f.name)
    np.savez(path, **arrays)


def load_npz(path: str | Path) -> tuple[OhashiSplit, OhashiSplit]:
    data = np.load(path, allow_pickle=False)
    out = []
    for tag in ("train", "test"):
        kw = {f.name: data[f"{tag}_{f.name}"] for f in
              dataclasses.fields(OhashiSplit)}
        kw["types"] = kw["types"].astype(str)
        out.append(OhashiSplit(**kw))
    return tuple(out)
