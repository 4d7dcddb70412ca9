"""Aggregate the honest-push regression runs across fold-split seeds into a
multi-split table (VERDICT round-3 item 2: put the honest headline on a
multi-split footing).

Reads the full-stack artifacts
  results/regression_maccs_honest_full.json      (campaign seed 42)
  results/regression_maccs_honest_seed43.json
  results/regression_maccs_honest_seed44.json
(skipping any that have not landed yet), writes results/SPLIT_SEEDS.json with
per-seed stacked numbers plus mean/sd, and prints the markdown table for
RESULTS.md / README. CPU-only: no JAX import, safe to run while a device job
is busy.

Reference bar this measures against: the single-split stacked artifact of
/root/reference/Models/multi_input_data_regression_opt_transformer_cnn_20250113.py:394-403.
"""
import json
import math
import os

OUT = "/root/repo/results"
SOURCES = [
    (42, f"{OUT}/regression_maccs_honest_full.json"),
    (43, f"{OUT}/regression_maccs_honest_seed43.json"),
    (44, f"{OUT}/regression_maccs_honest_seed44.json"),
]


def mean_sd(xs):
    m = sum(xs) / len(xs)
    sd = math.sqrt(sum((x - m) ** 2 for x in xs) / (len(xs) - 1)) if len(xs) > 1 else 0.0
    return m, sd


def main():
    rows = []
    for seed, path in SOURCES:
        if not os.path.exists(path):
            print(f"[split-table] {path} not present yet; skipping seed {seed}")
            continue
        with open(path) as f:
            rep = json.load(f)
        rows.append({
            "seed": seed,
            "stacked_r2": rep["stacked"]["r2"],
            "stacked_mse": rep["stacked"]["mse"],
            "crossfit_r2": rep["stacked_crossfit"]["r2"],
            "crossfit_mse": rep["stacked_crossfit"]["mse"],
            "source": os.path.basename(path),
        })
    if len(rows) < 2:
        print("[split-table] fewer than 2 seeds available; nothing to aggregate")
        return 1

    summary = {"per_seed": rows}
    for key in ("stacked_r2", "stacked_mse", "crossfit_r2", "crossfit_mse"):
        m, sd = mean_sd([r[key] for r in rows])
        summary[f"{key}_mean"] = m
        summary[f"{key}_sd"] = sd
    with open(f"{OUT}/SPLIT_SEEDS.json", "w") as f:
        json.dump(summary, f, indent=1)
    print(f"[split-table] wrote {OUT}/SPLIT_SEEDS.json ({len(rows)} seeds)\n")

    print("| split seed | stacked R² (in-sample meta) | stacked R² (cross-fitted) | MSE |")
    print("|---|---|---|---|")
    for r in rows:
        tag = " (campaign)" if r["seed"] == 42 else ""
        print(f"| {r['seed']}{tag} | {r['stacked_r2']:.4f} | "
              f"{r['crossfit_r2']:.4f} | {r['stacked_mse']:.4f} |")
    print(f"| **mean ± sd** | {summary['stacked_r2_mean']:.4f} ± "
          f"{summary['stacked_r2_sd']:.4f} | {summary['crossfit_r2_mean']:.4f} ± "
          f"{summary['crossfit_r2_sd']:.4f} | {summary['stacked_mse_mean']:.4f} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
