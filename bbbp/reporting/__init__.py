"""Reporting & interpretability (L5): metrics persistence, the reference's
plot suite, and attribution (exact TreeSHAP on the JAX forests, integrated
gradients for the NN branches) — SURVEY.md §2 L5 and §5 observability."""

from bbbp.reporting.metrics_io import write_metrics_csv, append_jsonl
