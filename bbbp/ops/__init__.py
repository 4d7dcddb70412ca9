"""XLA feature-engineering and classical-ML ops.

Device re-expressions of the reference's sklearn/imblearn preprocessing
stack (SURVEY.md §2.3) plus the tensorized decision-forest engine replacing
RF/XGBoost/CatBoost (SURVEY.md §7 design stance).
"""

from bbbp.ops.scaler import StandardScaler
from bbbp.ops.pca import PCA
from bbbp.ops.interactions import interaction_features
from bbbp.ops import metrics

__all__ = ["StandardScaler", "PCA", "interaction_features", "metrics"]
