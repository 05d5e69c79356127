"""Generic multi-seed replication driver — beyond-parity robustness tool.

Re-runs ANY experiment script under several independent seeds, each in its
own scratch artifact/result directory (fresh retrain per seed, one
subprocess per seed), then aggregates every
numeric scalar leaf of the per-seed metrics JSON into mean/sd/min/max.
The reference has no analogue: replicating its pipelines across seeds
costs CPU-hours per seed; here a full flagship or SAEM replicate is
seconds-to-minutes, so seed-sensitivity becomes a routinely checkable
property instead of a footnote (e.g. the reference-parity SAEM Ω update's
initialization sensitivity, ``src/saem.jl:204-205``).

    python experiments/exp_replicate.py --script exp06_saem --seeds 1 2 3
    → results/replicate_exp06_saem.json

Seeds whose scratch metrics already exist are skipped (crash-resumable);
``--retrain`` forces re-runs.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ARTIFACTS = HERE.parent / "artifacts"
RESULTS = HERE.parent / "results"


def resolve_script(name: str) -> Path:
    cands = sorted(p for p in HERE.glob("exp*.py")
                   if p.stem == name or p.stem.startswith(name))
    exact = [p for p in cands if p.stem == name]
    if exact:
        return exact[0]
    if len(cands) != 1:
        sys.exit(f"--script {name!r}: "
                 + (f"ambiguous {[p.stem for p in cands]}" if cands
                    else "no experiments/exp*.py match"))
    return cands[0]


def flatten(metrics, prefix=""):
    """Dotted-path → value for every numeric scalar leaf."""
    out = {}
    if isinstance(metrics, dict):
        for k, v in metrics.items():
            out.update(flatten(v, f"{prefix}{k}."))
    elif isinstance(metrics, bool):
        pass
    elif isinstance(metrics, (int, float)) and np.isfinite(metrics):
        out[prefix[:-1]] = float(metrics)
    return out


def run_seed(script: Path, seed: int, args, extra) -> dict:
    tag = f"{script.stem}_seed{seed}"
    art = args.scratch / "artifacts" / tag
    res = args.scratch / "results" / tag
    sub = "smoke" if args.smoke else ""
    done = sorted((res / sub).glob("*_metrics*.json")) if res.exists() else []
    if done and not args.retrain:
        print(f"[replicate] seed {seed}: cached {done[0].name}",
              file=sys.stderr)
        return json.loads(done[0].read_text())
    art.mkdir(parents=True, exist_ok=True)
    res.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, str(script), "--seed", str(seed),
           "--artifacts", str(art), "--results", str(res)] \
        + (["--smoke"] if args.smoke else []) + extra
    proc = subprocess.run(cmd, cwd=HERE.parent, timeout=args.timeout)
    if proc.returncode != 0:
        sys.exit(f"seed {seed}: {script.stem} exited {proc.returncode}")
    done = sorted((res / sub).glob("*_metrics*.json"))
    if not done:
        sys.exit(f"seed {seed}: no *_metrics.json under {res / sub}")
    return json.loads(done[0].read_text())


def main():
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--script", required=True,
                   help="experiment stem or unique prefix (e.g. exp06_saem)")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--smoke", action="store_true",
                   help="pass --smoke through (CI path)")
    p.add_argument("--retrain", action="store_true",
                   help="ignore cached per-seed scratch metrics")
    p.add_argument("--timeout", type=int, default=3600,
                   help="per-seed subprocess timeout (s)")
    p.add_argument("--scratch", type=Path, default=ARTIFACTS / "replicate",
                   help="per-seed scratch root (gitignored)")
    p.add_argument("--results", type=Path, default=RESULTS)
    p.add_argument("extra", nargs="*",
                   help="extra args passed through to the script "
                        "(prefix with -- to separate)")
    args = p.parse_args()

    script = resolve_script(args.script)
    per_seed = {seed: run_seed(script, seed, args, args.extra)
                for seed in args.seeds}

    flat = {seed: flatten(m) for seed, m in per_seed.items()}
    keys = sorted({k for f in flat.values() for k in f})
    aggregate = {}
    for k in keys:
        vals = np.asarray([f[k] for f in flat.values() if k in f])
        if len(vals) < 2:
            continue
        aggregate[k] = {"mean": float(vals.mean()),
                        "sd": float(vals.std(ddof=1)),
                        "min": float(vals.min()), "max": float(vals.max())}

    out = args.results / ("smoke" if args.smoke else "") \
        / f"replicate_{script.stem}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({
        "script": script.stem,
        "seeds": list(per_seed),
        "aggregate": aggregate,
        "per_seed": per_seed,
    }, indent=1))
    print(json.dumps({"script": script.stem, "n_seeds": len(per_seed),
                      "aggregated_keys": len(aggregate)}))


if __name__ == "__main__":
    main()
