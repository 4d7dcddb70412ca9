from bbbp.models.fusion import (
    MultiHeadAttentionFusion,
    AttentionFusion,
    MultiModalAttentionFusion,
)
from bbbp.models.mlp import DualBranchMLP
from bbbp.models.transformer_cnn import MultiModalRegressor
from bbbp.models.flow import FlowModel

__all__ = [
    "MultiHeadAttentionFusion",
    "AttentionFusion",
    "MultiModalAttentionFusion",
    "DualBranchMLP",
    "MultiModalRegressor",
    "FlowModel",
]
