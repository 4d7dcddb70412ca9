"""Dataset analysis (D11 equivalent): property distributions + chemical-space
projections, as a CLI instead of notebooks.

Reference: ``B3DB/notebooks/*.ipynb`` — PCA projection of descriptors/ECFP6
and property distributions. Outputs: per-descriptor histograms split by
BBB+/BBB− (or logBB sign), a descriptor-space PCA scatter, and a summary CSV.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

from bbbp.chem.descriptors import DESCRIPTOR_NAMES, descriptor_matrix
from bbbp.data import load_b3db_classification, load_b3db_regression
from bbbp.ops import PCA, StandardScaler


def analyze(dataset: str = "classification", out_dir: str = "analysis_output",
            workers: Optional[int] = None) -> dict:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if dataset == "classification":
        data = load_b3db_classification()
        labels = data.labels
        label_names = ("BBB-", "BBB+")
    else:
        data = load_b3db_regression()
        labels = (data.logbb > 0).astype(int)
        label_names = ("logBB<=0", "logBB>0")
    desc, bad = descriptor_matrix(data.smiles)
    ok = np.ones(len(desc), bool)
    ok[bad] = False
    desc, labels = desc[ok], labels[ok]
    os.makedirs(out_dir, exist_ok=True)

    # per-descriptor distributions by class
    import csv

    summary_path = os.path.join(out_dir, f"descriptor_summary_{dataset}.csv")
    with open(summary_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["descriptor", "mean_neg", "mean_pos", "std_neg", "std_pos"])
        for i, name in enumerate(DESCRIPTOR_NAMES):
            neg, pos = desc[labels == 0, i], desc[labels == 1, i]
            w.writerow([name, f"{neg.mean():.3f}", f"{pos.mean():.3f}",
                        f"{neg.std():.3f}", f"{pos.std():.3f}"])

    ncols = 5
    nrows = -(-len(DESCRIPTOR_NAMES) // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(3 * ncols, 2.2 * nrows))
    for i, name in enumerate(DESCRIPTOR_NAMES):
        ax = axes.flat[i]
        lo, hi = np.percentile(desc[:, i], [1, 99])
        bins = np.linspace(lo, max(hi, lo + 1e-6), 30)
        ax.hist(desc[labels == 0, i], bins=bins, alpha=0.5, density=True,
                label=label_names[0])
        ax.hist(desc[labels == 1, i], bins=bins, alpha=0.5, density=True,
                label=label_names[1])
        ax.set_title(name, fontsize=7)
        ax.tick_params(labelsize=5)
    for j in range(len(DESCRIPTOR_NAMES), nrows * ncols):
        axes.flat[j].axis("off")
    axes.flat[0].legend(fontsize=6)
    dist_path = os.path.join(out_dir, f"descriptor_distributions_{dataset}.png")
    fig.savefig(dist_path, dpi=200, bbox_inches="tight")
    plt.close(fig)

    # descriptor-space PCA
    from bbbp.reporting.plots import pca_space_plot

    z = np.asarray(PCA(2).fit_transform(
        np.asarray(StandardScaler().fit_transform(desc))))
    pca_path = os.path.join(out_dir, f"descriptor_pca_{dataset}.png")
    pca_space_plot(z, labels, pca_path, label_names=label_names)
    print(f"saved {summary_path}, {dist_path}, {pca_path}")
    return {"summary": summary_path, "distributions": dist_path, "pca": pca_path}


def main():
    ap = argparse.ArgumentParser(description="Dataset analysis (D11)")
    ap.add_argument("--dataset", default="classification",
                    choices=["classification", "regression"])
    ap.add_argument("--out-dir", default="analysis_output")
    args = ap.parse_args()
    analyze(args.dataset, args.out_dir)


if __name__ == "__main__":
    main()
